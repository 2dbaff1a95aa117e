"""Cross-implementation golden fixtures, part 3 (VERDICT round-3 missing
item 1): the four remaining hard kernels whose coverage previously relied on
repo-internal enumeration/FD tests only.

Every expected literal was produced by hand-evaluating the reference C++
FORMULAS (transliterated below in float64, independent of any repo kernel
code) at pinned inputs.  `test_generator3_matches_literals` pins the
transliterations to the committed literals so neither side can drift, and
the remaining tests pin the repo kernels to the same literals.

Covered formulas:
  * affine-alignment quaternion eigenproblem + its first-order
    eigenvector-perturbation derivative          src/eig.cpp:277-470
  * rama_coord phi/psi incl. dummy angles, via
    dihedral_germ (Blondel-Karplus)              src/bonds.cpp:171-249,
                                                 src/vector_math.h:704-735
  * Rama placement interpolation (periodic-2D
    spline at scaled rama coords + affine point
    transform + rama-gradient scaling)           src/placement.cpp:20-100,
                                                 183-201
  * fixed_hmm forward-algorithm potential,
    posterior marginals, expected edge
    transition counts                            src/hmm.cpp:38-216
  * TorusDBN emission energies + rama gradient   src/hmm.cpp:218-358
"""

import jax
import jax.numpy as jnp
import numpy as np

from upside_md.nodes.basic import DUMMY_RAMA_ANGLE, _rama_coord
from upside_md.nodes.hmm import _fixed_hmm, _torus_dbn
from upside_md.nodes.placement import _rama_placement
from upside_md.ops.geometry import rigid_alignment
from upside_md.ops.spline import fit_periodic_bspline_2d

from test_reference_goldens2 import (_ref_eval_periodic_2d,
                                     _ref_quat_to_rot,
                                     _ref_solve_periodic_2d)

# ---------------------------------------------------------------------------
# Reference-formula transliterations (float64; no repo kernel code)
# ---------------------------------------------------------------------------


def _ref_affine_value(atoms, ref_geom):
    """AffineAlignment::compute_value (src/eig.cpp:317-386): center the 3
    atoms, build the 3x3 correlation R against the (centered) reference
    geometry, assemble the symmetric traceless 4x4 quaternion matrix F
    (:346-353), and take the largest-eigenvalue eigenvector as the
    rotation quaternion.  The reference runs Householder + implicit QR
    (symm_QR_4x4, :232-273); the spectral decomposition itself is
    algorithm-independent, so float64 eigh stands in for it here."""
    atoms = np.asarray(atoms, np.float64)
    ref_geom = np.asarray(ref_geom, np.float64)
    center = atoms.mean(0)
    x = atoms - center
    R = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            R[i, j] = sum(x[a, j] * ref_geom[a, i] for a in range(3))
    F = np.array([
        [R[0,0]+R[1,1]+R[2,2], R[1,2]-R[2,1], R[2,0]-R[0,2], R[0,1]-R[1,0]],
        [R[1,2]-R[2,1], R[0,0]-R[1,1]-R[2,2], R[0,1]+R[1,0], R[0,2]+R[2,0]],
        [R[2,0]-R[0,2], R[0,1]+R[1,0], -R[0,0]+R[1,1]-R[2,2], R[1,2]+R[2,1]],
        [R[0,1]-R[1,0], R[0,2]+R[2,0], R[1,2]+R[2,1], -R[0,0]-R[1,1]+R[2,2]]])
    evals, evecs = np.linalg.eigh(F)
    order = np.argsort(evals)[::-1]
    evals = evals[order]
    evecs = evecs[:, order]
    q = evecs[:, 0]
    if q[np.argmax(np.abs(q))] < 0:       # pin the arbitrary sign
        q = -q
        evecs = evecs.copy()
        evecs[:, 0] = q
    return center, q, evals, evecs


def _ref_dF_packed(g, j):
    """The dF/d(atom position component j) matrices of the reference's
    three `perturb` calls (src/eig.cpp:446-462), packed upper-triangle
    (00,01,02,03,11,12,13,22,23,33); g is the atom's (centered) reference
    geometry row."""
    g0, g1, g2 = g
    if j == 0:
        return [g0, 0.0, g2, -g1, g0, g1, g2, -g0, 0.0, -g0]
    if j == 1:
        return [g1, -g2, 0.0, g0, -g1, g0, 0.0, g1, g2, -g1]
    return [g2, g1, -g0, 0.0, -g2, 0.0, g0, -g2, g1, g2]


_TRI = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (0, 3): 3, (1, 1): 4, (1, 2): 5,
        (1, 3): 6, (2, 2): 7, (2, 3): 8, (3, 3): 9}


def _ref_affine_grad(atoms, ref_geom, sens3, qc):
    """AffineAlignment::propagate_deriv (src/eig.cpp:388-470): translation
    sensitivity spread 1/3 to each atom, plus the quaternion cotangent
    pushed through first-order eigenvector perturbation theory,
    d(quat)/d(pos) = sum_k (v_k^T dF v_0)/(l_0 - l_k) * v_k (:425-470).
    qc is the quaternion cotangent directly (the reference receives a
    torque and converts; that conversion identity is golden-tested
    separately, commit 7d03c71)."""
    _, _, evals, evecs = _ref_affine_value(atoms, ref_geom)
    inv_evals = [0.0] + [1.0 / (evals[0] - evals[k]) for k in range(1, 4)]
    qc_basis = [np.dot(qc, evecs[:, k]) for k in range(4)]
    grad = np.zeros((3, 3))
    for na in range(3):
        g = ref_geom[na]
        for j in range(3):
            f = _ref_dF_packed(g, j)
            d = sens3[j] / 3.0
            for k in range(1, 4):
                c = 0.0
                for i in range(4):
                    for jj in range(i, 4):
                        t = f[_TRI[(i, jj)]]
                        if i == jj:
                            c += t * evecs[i, k] * evecs[jj, 0]
                        else:
                            c += t * (evecs[i, k] * evecs[jj, 0]
                                      + evecs[jj, k] * evecs[i, 0])
                d += inv_evals[k] * c * qc_basis[k]
            grad[na, j] = d
    return grad


def _ref_dihedral_germ(r1, r2, r3, r4):
    """dihedral_germ (src/vector_math.h:704-735), Blondel-Karplus
    formulas.  Returns (angle, (4, 3) derivative)."""
    r1, r2, r3, r4 = [np.asarray(r, np.float64) for r in (r1, r2, r3, r4)]
    F = r1 - r2
    G = r2 - r3
    H = r4 - r3
    A = np.cross(F, G)
    B = np.cross(H, G)
    C = np.cross(B, A)
    iA = 1.0 / (A @ A)
    iB = 1.0 / (B @ B)
    Gmag = np.sqrt(G @ G)
    d1 = -Gmag * iA * A
    d4 = Gmag * iB * B
    f_mid = (F @ G) * iA / Gmag * A - (H @ G) * iB / Gmag * B
    d2 = -d1 + f_mid
    d3 = -d4 - f_mid
    theta = np.arctan2(C @ G, (A @ B) * Gmag)
    return theta, np.stack([d1, d2, d3, d4])


def _ref_rama_coord(atoms5):
    """RamaCoord::compute_value (src/bonds.cpp:205-228): phi over atoms
    0..3, psi over atoms 1..4, with the (2, 5, 3) jacobian laid out as the
    reference's jac array."""
    phi, dphi = _ref_dihedral_germ(*atoms5[0:4])
    psi, dpsi = _ref_dihedral_germ(*atoms5[1:5])
    jac = np.zeros((2, 5, 3))
    jac[0, 0:4] = dphi
    jac[1, 1:5] = dpsi
    return np.array([phi, psi]), jac


def _ref_rama_placement(placement_data, layer, rama, t, qn, sens):
    """RamaPlacement<3>::evaluate + propagate_deriv (src/placement.cpp:
    60-100) composed with the POINT affine transform (:183-201):
    grid coords x = (phi+pi) * nx * (0.5/pi - 1e-7) (:61-63, 76), value
    from the layered periodic 2D spline, out = R v + t, and the rama
    gradient rd = scale * dot(local_sens, dvalue/dcoord) (:86-92) with
    local_sens = R^T sens (the point transform's pullback)."""
    nl, nx, ny, w = placement_data.shape
    phi, psi = rama
    scale_x = nx * (0.5 / np.pi - 1e-7)
    scale_y = ny * (0.5 / np.pi - 1e-7)
    x = (phi + np.pi) * scale_x
    y = (psi + np.pi) * scale_y
    val = np.zeros(w)
    dx = np.zeros(w)
    dy = np.zeros(w)
    for d in range(w):
        coeff = _ref_solve_periodic_2d(placement_data[layer, :, :, d])
        val[d], dx[d], dy[d] = _ref_eval_periodic_2d(coeff, x, y)
    R = _ref_quat_to_rot(qn)
    out = R @ val + t
    local_sens = R.T @ np.asarray(sens, np.float64)
    rd = np.array([scale_x * (local_sens @ dx), scale_y * (local_sens @ dy)])
    return out, rd


def _ref_hmm(e1b, te):
    """FixedHMM::compute_value (src/hmm.cpp:63-216): softmin energy
    offset (:63-69), per-residue min-shifted emission probabilities
    (:113-136), normalized forward pass accumulating -log(norm) into the
    potential (:140-152), posterior marginals from the backward pass
    (= sens, :157-168), and expected edge transition counts (= the
    transition-energy parameter derivative, :183-195)."""
    e1b = np.asarray(e1b, np.float64)
    te = np.asarray(te, np.float64)
    n_res, n_state = e1b.shape
    e_min = te.min()
    w = np.exp(e_min - te)
    offset = (te * w).sum() / w.sum()
    T = np.exp(offset - te)

    pot = offset * (n_res - 1.0)
    emission = np.zeros_like(e1b)
    for nr in range(n_res):
        em = e1b[nr].min()
        pot += em
        emission[nr] = np.exp(em - e1b[nr])

    forward_belief = np.zeros_like(e1b)
    forward = np.ones(n_state)
    for nr in range(n_res):
        if nr:
            forward = forward @ T
        forward = forward * emission[nr]
        norm = forward.sum()
        pot -= np.log(norm)
        forward = forward / norm
        forward_belief[nr] = forward

    marginals = np.zeros_like(e1b)
    edge_counts = np.zeros((n_state, n_state))
    backward = np.ones(n_state)
    for nr in range(n_res - 1, -1, -1):
        marginal = forward_belief[nr] * backward
        marginal /= marginal.sum()
        marginals[nr] = marginal
        if nr > 0:
            backward = backward * emission[nr]
            un = T * np.outer(forward_belief[nr - 1], backward)
            edge_counts += un / un.sum()
            backward = T @ backward
            backward /= backward.sum()
    return pot, marginals, edge_counts


def _ref_torus_dbn(rama, basin_param, prior, restypes, sens):
    """TorusDBN_Emission (src/hmm.cpp:239-332): cs feature row
    (cos/sin of phi, psi, phi-psi, :300-310), cs_to_emission columns from
    basin params with the TorusDBN sign convention (:276-296), output =
    prior_offset + cs @ cs_to_emission where prior_offset adds the basin
    log-normalization bp[0] (:240-243), and the phi/psi sensitivity of
    :319-331."""
    rama = np.asarray(rama, np.float64)
    bp = np.asarray(basin_param, np.float64)
    n_res = rama.shape[0]
    n_state = bp.shape[0]
    cs = np.zeros((n_res, 6))
    for nr in range(n_res):
        phi, psi = rama[nr]
        cs[nr] = [np.cos(phi), np.sin(phi), np.cos(psi), np.sin(psi),
                  np.cos(phi - psi), np.sin(phi - psi)]
    c2e = np.zeros((6, n_state))
    for ns in range(n_state):
        kp, ap, kq, aq, kc = bp[ns, 1:6]
        ac = ap - aq
        c2e[0, ns] = -kp * np.cos(ap)
        c2e[1, ns] = -kp * np.sin(ap)
        c2e[2, ns] = -kq * np.cos(aq)
        c2e[3, ns] = -kq * np.sin(aq)
        c2e[4, ns] = kc * np.cos(ac)
        c2e[5, ns] = kc * np.sin(ac)
    out = prior[restypes] + bp[None, :, 0] + cs @ c2e
    cs_sens = c2e @ np.asarray(sens, np.float64).T
    rgrad = np.zeros((n_res, 2))
    for nr in range(n_res):
        rgrad[nr, 0] = (-cs[nr, 1] * cs_sens[0, nr]
                        + cs[nr, 0] * cs_sens[1, nr]
                        - cs[nr, 5] * cs_sens[4, nr]
                        + cs[nr, 4] * cs_sens[5, nr])
        rgrad[nr, 1] = (-cs[nr, 3] * cs_sens[2, nr]
                        + cs[nr, 2] * cs_sens[3, nr]
                        + cs[nr, 5] * cs_sens[4, nr]
                        - cs[nr, 4] * cs_sens[5, nr])
    return out, rgrad


# ---------------------------------------------------------------------------
# Pinned inputs and golden literals
# ---------------------------------------------------------------------------

AF_ATOMS = np.array([[1.2, 0.3, -0.5],
                     [2.0, 1.1, 0.4],
                     [0.7, 1.9, 1.3]])
AF_REF = np.array([[0.9, -0.4, 0.1],         # centered: columns sum to 0
                   [-0.3, 0.8, -0.6],
                   [-0.6, -0.4, 0.5]])
AF_SENS3 = np.array([0.7, -1.1, 0.4])
AF_QC = np.array([0.3, -0.8, 0.5, 1.2])
AF_CENTER = [1.3, 1.0999999999999999, 0.4000000000000001]
AF_QUAT = [-0.532766797841234, -0.4180283698941166,
           0.0164102334419851, 0.735623902085872]
AF_GRAD = [[0.16870983949536844, -0.12312950110234672, -0.03953086517832061],
           [0.249467846591728, -0.7968399484839654, 0.4158864868764825],
           [0.28182231391290335, -0.18003055041368804, 0.023644378301838125]]

RC_ATOMS = np.array([[0.1, -0.4, 1.2],
                     [1.5, 0.3, 0.2],
                     [2.8, 1.4, 0.9],
                     [4.1, 0.8, 1.7],
                     [5.3, 1.9, 1.1]])
RC_PHI_PSI = [1.4376888102419056, 2.4694569215114384]
RC_JAC = [[[-0.3603787170007623, 0.5167694809822252, -0.1427915671135096],
           [0.7316271067769574, -0.8219128277897154, -0.06715875463051107],
           [-0.7344032741849125, 0.34145883524836196, 0.8273136252388402],
           [0.3631548844087173, -0.03631548844087174, -0.6173633034948195],
           [0.0, 0.0, 0.0]],
          [[0.0, 0.0, 0.0],
           [-0.32349545299520166, 0.03234954529952017, 0.5499422700918428],
           [0.4978943452493826, 0.0047854712274761554, -0.8054892076096396],
           [-0.06672091582888583, -0.3974420914885607, -0.1896600803944809],
           [-0.1076779764252951, 0.36030707496156433, 0.44520701791227774]]]

# placement: 2 layers of 8x8x3 data, pinned via a seeded rng + rounding
PL_DATA = np.round(
    np.random.default_rng(42).uniform(-1.5, 1.5, size=(2, 8, 8, 3)), 3)
PL_RAMA = np.array([-1.1, 2.3])
PL_T = np.array([0.5, -1.2, 0.8])
PL_Q = np.array([0.9233805168766387, 0.20519567041703082,
                 -0.3077935056255462, 0.10259783520851541])
PL_SENS = np.array([1.3, -0.7, 0.4])
PL_OUT = [1.281192485562333, -1.9678885066539205, 0.19511052125961403]
PL_RD = [-0.8903540195404106, 4.005017660933951]

HMM_E1B = np.array([[0.5, -0.3, 1.2],
                    [-0.8, 0.4, 0.1],
                    [1.5, 0.2, -0.6],
                    [0.3, 0.9, -0.2]])
HMM_TE = np.array([[0.2, 1.4, 2.1],
                   [1.1, 0.3, 1.7],
                   [2.3, 0.9, 0.1]])
HMM_POT = -1.2535954306264427
HMM_MARG = [[0.26897364288585635, 0.5208520513496704, 0.2101743057644733],
            [0.37962730425037045, 0.2382596038191301, 0.3821130919304994],
            [0.11543865380066134, 0.24967881037104045, 0.6348825358282982],
            [0.1966931435458898, 0.1891042409835693, 0.6142026154705409]]
HMM_EDGE_COUNTS = [
    [0.37191215479652123, 0.13805639411722498, 0.25407105202314195],
    [0.27009999826660613, 0.3986733361532806, 0.3400171311199543],
    [0.04974694853379417, 0.14031292490323427, 1.0371100600862424]]

TD_RAMA = np.array([[-1.2, 2.4], [0.5, -0.9], [2.9, 0.1]])
TD_BP = np.array([[0.3, 1.5, -0.8, 2.0, 1.1, 0.6],
                  [-0.2, 0.7, 2.2, 1.3, -2.4, 0.9],
                  [0.1, 2.4, 0.4, 0.6, 0.2, -0.5]])
TD_PRIOR = np.array([[0.15, -0.4, 0.9], [1.2, 0.3, -0.7]])
TD_RESTYPES = np.array([0, 1, 0])
TD_SENS = np.array([[0.4, -1.1, 0.8], [0.2, 0.9, -0.5], [-0.6, 0.3, 1.0]])
TD_OUT = [[-1.5438958448308173, -0.34222931855110894, 1.8186633798335086],
          [1.3385575682120852, -0.8002325143764243, -3.441346546760945],
          [0.6341122377515985, -0.29838471611190637, 2.7541865548302993]]
TD_RGRAD = [[-2.798179512012836, 3.0320207530297054],
            [-0.7168448193070474, 1.3320757159858578],
            [2.2091885605118233, 1.0225520944571538]]


# ---------------------------------------------------------------------------
# Generator self-check: transliterations reproduce the committed literals
# ---------------------------------------------------------------------------

def test_generator3_matches_literals():
    center, q, _, _ = _ref_affine_value(AF_ATOMS, AF_REF)
    np.testing.assert_allclose(center, AF_CENTER, rtol=1e-13)
    np.testing.assert_allclose(q, AF_QUAT, rtol=1e-10)
    grad = _ref_affine_grad(AF_ATOMS, AF_REF, AF_SENS3, AF_QC)
    np.testing.assert_allclose(grad, AF_GRAD, rtol=1e-10)

    val, jac = _ref_rama_coord(RC_ATOMS)
    np.testing.assert_allclose(val, RC_PHI_PSI, rtol=1e-13)
    np.testing.assert_allclose(jac, RC_JAC, rtol=1e-12, atol=1e-15)

    out, rd = _ref_rama_placement(PL_DATA, 1, PL_RAMA, PL_T, PL_Q, PL_SENS)
    np.testing.assert_allclose(out, PL_OUT, rtol=1e-12)
    np.testing.assert_allclose(rd, PL_RD, rtol=1e-12)

    pot, marg, ec = _ref_hmm(HMM_E1B, HMM_TE)
    np.testing.assert_allclose(pot, HMM_POT, rtol=1e-13)
    np.testing.assert_allclose(marg, HMM_MARG, rtol=1e-12)
    np.testing.assert_allclose(ec, HMM_EDGE_COUNTS, rtol=1e-12)

    out, rg = _ref_torus_dbn(TD_RAMA, TD_BP, TD_PRIOR, TD_RESTYPES, TD_SENS)
    np.testing.assert_allclose(out, TD_OUT, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(rg, TD_RGRAD, rtol=1e-12)


# ---------------------------------------------------------------------------
# Repo kernels vs the golden literals
# ---------------------------------------------------------------------------

def test_affine_alignment_vs_golden():
    """rigid_alignment (ops/geometry.py): Newton-on-quartic +
    Cayley-Hamilton adjugate vs the reference eigenproblem; autodiff vs
    the reference's explicit eigenvector perturbation theory."""
    atoms = jnp.asarray(AF_ATOMS, jnp.float64)
    ref = jnp.asarray(AF_REF, jnp.float64)
    center, quat = rigid_alignment(atoms, ref)
    np.testing.assert_allclose(np.asarray(center), AF_CENTER, rtol=1e-12)
    # quaternion sign is arbitrary (documented); compare up to sign
    dot = float(jnp.dot(quat, jnp.asarray(AF_QUAT)))
    np.testing.assert_allclose(abs(dot), 1.0, atol=1e-7)

    sign = np.sign(dot)

    def loss(a):
        c, q = rigid_alignment(a, ref)
        return (jnp.dot(jnp.asarray(AF_SENS3), c)
                + sign * jnp.dot(jnp.asarray(AF_QC), q))

    grad = jax.grad(loss)(atoms)
    np.testing.assert_allclose(np.asarray(grad), AF_GRAD,
                               rtol=1e-6, atol=1e-8)


def test_rama_coord_vs_golden():
    consts = {"id": np.array([[0, 1, 2, 3, 4]]),
              "dummy": np.zeros((1, 2), bool)}
    pos = jnp.asarray(RC_ATOMS, jnp.float64)
    val = _rama_coord(consts, {}, [pos], None)
    np.testing.assert_allclose(np.asarray(val)[0], RC_PHI_PSI, rtol=1e-10)

    jac = jax.jacobian(lambda p: _rama_coord(consts, {}, [p], None))(pos)
    np.testing.assert_allclose(np.asarray(jac)[0].transpose(0, 1, 2),
                               RC_JAC, rtol=1e-9, atol=1e-12)


def test_rama_coord_dummy_angles_vs_golden():
    """N-terminal phi / C-terminal psi dummies: the constant -80 degrees
    (bonds.cpp:220 literal -1.3963) with zero position derivative."""
    consts = {"id": np.array([[0, 0, 1, 2, 3], [1, 2, 3, 4, 4]]),
              "dummy": np.array([[True, False], [False, True]])}
    pos = jnp.asarray(RC_ATOMS, jnp.float64)
    val = np.asarray(_rama_coord(consts, {}, [pos], None))
    np.testing.assert_allclose(val[0, 0], -1.3963, rtol=1e-12)
    np.testing.assert_allclose(val[1, 1], -1.3963, rtol=1e-12)

    jac = np.asarray(
        jax.jacobian(lambda p: _rama_coord(consts, {}, [p], None))(pos))
    assert np.all(np.isfinite(jac))
    np.testing.assert_allclose(jac[0, 0], 0.0, atol=1e-14)  # phi dummy
    np.testing.assert_allclose(jac[1, 1], 0.0, atol=1e-14)  # psi dummy
    # the live angles of the same residues keep real derivatives
    assert np.abs(jac[0, 1]).max() > 0.01
    assert np.abs(jac[1, 0]).max() > 0.01


def test_rama_placement_vs_golden():
    compute = _rama_placement(("point",))
    # float64 coeffs (make_rama_placement_params casts to f32; the golden
    # pins the math, so fit at full precision the same way it does)
    coeffs = np.stack([fit_periodic_bspline_2d(PL_DATA[l, :, :, d])
                       for l in range(2) for d in range(3)], axis=0)
    coeffs = coeffs.reshape(2, 3, 8, 8).transpose(0, 2, 3, 1)
    params = {"coeffs": jnp.asarray(coeffs, jnp.float64)}
    consts = {"affine_residue": np.array([0]),
              "rama_residue": np.array([0]),
              "layer_index": np.array([1])}
    affine = jnp.asarray(np.concatenate([PL_T, PL_Q])[None], jnp.float64)
    rama = jnp.asarray(PL_RAMA[None], jnp.float64)

    out = compute(consts, params, [affine, rama], None)
    np.testing.assert_allclose(np.asarray(out)[0], PL_OUT, rtol=1e-9)

    rd = jax.grad(lambda r: jnp.sum(
        compute(consts, params, [affine, r], None)
        * jnp.asarray(PL_SENS)))(rama)
    np.testing.assert_allclose(np.asarray(rd)[0], PL_RD, rtol=1e-9)


def test_fixed_hmm_vs_golden():
    consts = {"index": np.arange(4)}
    params = {"transition_energy": jnp.asarray(HMM_TE, jnp.float64)}
    e1b = jnp.asarray(HMM_E1B, jnp.float64)

    pot = _fixed_hmm(consts, params, [e1b], None)
    np.testing.assert_allclose(float(pot), HMM_POT, rtol=1e-10)

    # sens = posterior marginals (hmm.cpp:157-168) via autodiff
    marg = jax.grad(lambda e: _fixed_hmm(consts, params, [e], None))(e1b)
    np.testing.assert_allclose(np.asarray(marg), HMM_MARG, rtol=1e-8)

    # transition-energy param deriv = expected edge counts (hmm.cpp:183-195)
    ec = jax.grad(lambda te: _fixed_hmm(
        consts, {"transition_energy": te}, [e1b], None))(
        jnp.asarray(HMM_TE, jnp.float64))
    np.testing.assert_allclose(np.asarray(ec), HMM_EDGE_COUNTS, rtol=1e-8)


def test_torus_dbn_vs_golden():
    consts = {"id": np.arange(3), "basin_param": jnp.asarray(TD_BP),
              "restypes": np.asarray(TD_RESTYPES)}
    params = {"prior_offset_energies": jnp.asarray(TD_PRIOR, jnp.float64)}
    rama = jnp.asarray(TD_RAMA, jnp.float64)

    out = _torus_dbn(consts, params, [rama], None)
    np.testing.assert_allclose(np.asarray(out), TD_OUT, rtol=1e-9,
                               atol=1e-12)

    rg = jax.grad(lambda r: jnp.sum(
        _torus_dbn(consts, params, [r], None) * jnp.asarray(TD_SENS)))(rama)
    np.testing.assert_allclose(np.asarray(rg), TD_RGRAD, rtol=1e-8)
