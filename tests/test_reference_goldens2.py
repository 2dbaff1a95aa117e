"""Cross-implementation golden fixtures, part 2 (round 3).

Same method as test_reference_goldens.py: every expected literal below was
produced by hand-evaluating reference C++ FORMULAS (transliterated here in
float64, independent of repo kernel code) at pinned inputs.
`test_generator2_matches_literals` pins the transliterations to the
committed literals; the remaining tests pin the repo kernels to the same
literals.

Covered formulas (extending VERDICT round-2 missing item 1):
  * compact sigmoid value+deriv w/ cutoffs     src/vector_math.h:640-658
  * environment-coverage edge + its
    hand-written derivative partition          src/environment.cpp:27-59
  * periodic cubic spline fit (cyclic
    system) + power-basis conversion           src/spline.cpp:121-156
  * periodic bicubic 2D fit + cell eval
    (the Rama-map interpolant)                 src/spline.cpp:261-291,
                                               src/spline.h:61-83,397-450
  * zero-slope clamped spline fit + the
    LayeredClampedSpline1D eval semantics      src/spline.cpp:192-259,
                                               src/spline.h:456-516
  * membrane potential composition
    (cb spline x burial gate + uhb term)       src/membrane_potential.cpp:105-150
  * sidechain-radial distance spline edge      src/sidechain_radial.cpp:30-62
"""

import jax
import jax.numpy as jnp
import numpy as np

from upside_md.nodes.env import _environment_coverage
from upside_md.nodes.membrane import (_membrane_potential,
                                          make_membrane_params)
from upside_md.nodes.radial import _radial_energy
from upside_md.ops.sigmoid import compact_sigmoid
from upside_md.ops.spline import (eval_clamped_interp,
                                      eval_periodic_bspline_2d,
                                      fit_clamped_interp_bspline,
                                      fit_periodic_bspline_2d)

from test_reference_goldens import _ref_clamped_deboor

# ---------------------------------------------------------------------------
# Reference-formula transliterations (float64; no repo kernel code)
# ---------------------------------------------------------------------------

# power-basis blend of one cubic B-spline over its 4 supporting cells
# (src/spline.cpp:114-118, bspline_coeffs)
BSPLINE_POWER = np.array([
    [0., 0., 0., 1.],
    [1., 3., 3., -3.],
    [4., 0., -6., 3.],
    [1., -3., 3., -1.]], np.float64) / 6.0


def _ref_compact_sigmoid(x, sharpness):
    """compact_sigmoid (src/vector_math.h:640-658): value
    0.25*(y+2)*(y-1)^2 for y=x*sharpness in [-1,1], 1 below, 0 above;
    derivative 0.75*sharpness*(y^2-1) inside, else 0."""
    y = x * sharpness
    if y < -1.0:
        return 1.0, 0.0
    if y > 1.0:
        return 0.0, 0.0
    return (0.25 * (y + 2.0) * (y - 1.0) * (y - 1.0),
            sharpness * 0.75 * (y * y - 1.0))


def _ref_env_edge(p, cb, sc):
    """EnvironmentCoverageInteraction::compute_edge
    (src/environment.cpp:27-59).  p = [r0, r_sharpness, dot0,
    dot_sharpness]; cb = CB pos+direction (6,), sc = pos+prob (4,).
    Returns (value, d_cb (6,), d_sc (4,)) — the reference's hand-written
    derivative partition."""
    cb, sc = np.asarray(cb, np.float64), np.asarray(sc, np.float64)
    r0, r_sharp, dot0, dot_sharp = [float(v) for v in p]
    displace = sc[0:3] - cb[0:3]
    rvec1 = cb[3:6]
    prob = sc[3]
    dist2 = displace @ displace
    inv_dist = 1.0 / np.sqrt(dist2)
    dist = dist2 * inv_dist
    u = inv_dist * displace
    dp = u @ rvec1
    rs, rsd = _ref_compact_sigmoid(dist - r0, r_sharp)
    as_, asd = _ref_compact_sigmoid(dot0 - dp, dot_sharp)
    d_displace = prob * (rsd * as_ * u
                         - rs * asd * inv_dist * (rvec1 - dp * u))
    score = rs * as_
    d_cb = np.concatenate([-d_displace, -prob * rs * asd * u])
    d_sc = np.concatenate([d_displace, [score]])
    return prob * score, d_cb, d_sc


def _ref_solve_periodic_1d(data):
    """solve_periodic_1d_spline (src/spline.cpp:121-156): solve the cyclic
    tridiagonal system (1/6, 2/3, 1/6) c = data (the Sherman-Morrison
    dance of spline.cpp:32-76 solves exactly this matrix; we form it
    explicitly), then blend the B-spline coefficients into per-cell
    {1,x,x^2,x^3} coefficients (:144-155).  Returns (n, 4) power coeffs."""
    data = np.asarray(data, np.float64)
    n = len(data)
    A = np.zeros((n, n))
    i = np.arange(n)
    A[i, i] = 2.0 / 3.0
    A[i, (i + 1) % n] = 1.0 / 6.0
    A[i, (i - 1) % n] = 1.0 / 6.0
    sol = np.linalg.solve(A, data)
    coeff = np.zeros((n, 4))
    for k in range(n):
        for inc in range(4):
            coeff[(k + inc - 2) % n] += sol[k] * BSPLINE_POWER[inc]
    return coeff


def _ref_solve_periodic_2d(data):
    """solve_periodic_2d_spline (src/spline.cpp:261-291): 1D fits along y,
    then 1D fits along x of each power-of-y coefficient.  data (nx, ny) ->
    (nx, ny, 4, 4) power coeffs indexed [ix, iy, power_x, power_y]."""
    data = np.asarray(data, np.float64)
    nx, ny = data.shape
    along_y = np.zeros((nx, ny, 4))
    for ix in range(nx):
        along_y[ix] = _ref_solve_periodic_1d(data[ix])
    coeff = np.zeros((nx, ny, 4, 4))
    for iy in range(ny):
        for py in range(4):
            cx = _ref_solve_periodic_1d(along_y[:, iy, py])
            coeff[:, iy, :, py] = cx
    return coeff


def _ref_eval_periodic_2d(coeff, x, y):
    """Per-cell bicubic evaluation + partials (src/spline.cpp:295-330,
    spline.h:61-83).  Returns (value, d/dx, d/dy)."""
    nx, ny = coeff.shape[0], coeff.shape[1]
    xb, yb = int(np.floor(x)), int(np.floor(y))
    fx, fy = x - xb, y - yb
    c = coeff[xb % nx, yb % ny]
    px = np.array([1.0, fx, fx * fx, fx * fx * fx])
    py = np.array([1.0, fy, fy * fy, fy * fy * fy])
    dpx = np.array([0.0, 1.0, 2.0 * fx, 3.0 * fx * fx])
    dpy = np.array([0.0, 1.0, 2.0 * fy, 3.0 * fy * fy])
    return (px @ c @ py, dpx @ c @ py, px @ c @ dpy)


def _ref_solve_clamped_1d(data):
    """solve_clamped_1d_spline (src/spline.cpp:192-259): zero-slope
    boundary folded into the tridiagonal (a[n-1]*=2, c[0]*=2), B-spline ->
    power conversion with the out-of-range wings re-added (:228-258).
    Returns (n-1, 4) per-cell power coeffs."""
    data = np.asarray(data, np.float64)
    n = len(data)
    A = np.zeros((n, n))
    i = np.arange(n)
    A[i, i] = 2.0 / 3.0
    A[i[:-1], i[:-1] + 1] = 1.0 / 6.0
    A[i[1:], i[1:] - 1] = 1.0 / 6.0
    A[0, 1] += 1.0 / 6.0          # c[-1] == c[1] fold
    A[n - 1, n - 2] += 1.0 / 6.0  # c[n] == c[n-2] fold
    sol = np.linalg.solve(A, data)
    coeff = np.zeros((n - 1, 4))
    for k in range(n):
        for inc in range(4):
            idx = k + inc - 2
            if 0 <= idx < n - 1:
                coeff[idx] += sol[k] * BSPLINE_POWER[inc]
    # wings: the folded coefficients c[-1]=sol[1] and c[n]=sol[n-2]
    # contribute their remaining in-range pieces (spline.cpp:240-258)
    coeff[0] += sol[1] * BSPLINE_POWER[3]
    coeff[n - 2] += sol[n - 2] * BSPLINE_POWER[0]
    return coeff


def _ref_eval_clamped_1d(coeff, data, x):
    """LayeredClampedSpline1D::evaluate_value_and_deriv
    (src/spline.h:496-516): constant value and zero slope outside
    [0, nx-1].  Returns (value, deriv)."""
    n = len(data)
    if x <= 0.0:
        return float(data[0]), 0.0
    if x >= n - 1:
        return float(data[n - 1]), 0.0
    xb = int(x)
    f = x - xb
    c = coeff[xb]
    return (c[0] + f * (c[1] + f * (c[2] + f * c[3])),
            c[1] + f * (2.0 * c[2] + f * 3.0 * c[3]))


def _ref_membrane(cb_energy, uhb_energy, cb_z, restype, cov, cov_mid,
                  cov_sharp, cb_z_shift, cb_z_scale, uhb_z_shift,
                  uhb_z_scale, hb_z, hb_prob, n_donor):
    """MembranePotential::compute_value (src/membrane_potential.cpp:105-150):
    sum_res cb_spline(restype, z) * compact_sigmoid(cov - mid, sharp)
    + sum_virtual uhb_spline(is_acceptor, z) * (1 - hb_prob)^2."""
    cb_coeffs = [_ref_solve_clamped_1d(row) for row in cb_energy]
    uhb_coeffs = [_ref_solve_clamped_1d(row) for row in uhb_energy]
    pot = 0.0
    for r in range(len(cb_z)):
        t = restype[r]
        v, _ = _ref_eval_clamped_1d(cb_coeffs[t], cb_energy[t],
                                    (cb_z[r] + cb_z_shift) * cb_z_scale)
        s, _ = _ref_compact_sigmoid(cov[r] - cov_mid[t], cov_sharp[t])
        pot += v * s
    for k in range(len(hb_z)):
        layer = int(k >= n_donor)
        v, _ = _ref_eval_clamped_1d(uhb_coeffs[layer], uhb_energy[layer],
                                    (hb_z[k] + uhb_z_shift) * uhb_z_scale)
        pot += v * (1.0 - hb_prob[k]) ** 2
    return pot


def _ref_quat_to_rot(q):
    """quat_to_rot (src/affine.h:98-108), [a,b,c,d] layout."""
    a, b, c, d = [float(v) for v in q]
    return np.array([
        [a*a + b*b - c*c - d*d, 2*(b*c - a*d), 2*(b*d + a*c)],
        [2*(b*c + a*d), a*a - b*b + c*c - d*d, 2*(c*d - a*b)],
        [2*(b*d - a*c), 2*(c*d + a*b), a*a - b*b - c*c + d*d]], np.float64)


def _ref_backbone_pairs(affines, ref_pos, n_atoms, ids):
    """BackbonePairs::compute_value (src/backbone_steric.cpp:82-146):
    atoms placed by the rigid frame, pairs with |id_i - id_j| > 1, each
    atom pair within cutoff2 = 9.3 contributing
    4 * compact_sigmoid(r^2 - 9, 1/0.3) (:16-30).  Returns
    (potential, d (n,3) translation sens, torque (n,3))."""
    affines = np.asarray(affines, np.float64)
    n = len(affines)
    atoms = []
    for nr in range(n):
        U = _ref_quat_to_rot(affines[nr, 3:7])
        t = affines[nr, 0:3]
        atoms.append([U @ np.asarray(ref_pos[nr][na], np.float64) + t
                      for na in range(n_atoms[nr])])
    pot = 0.0
    d = np.zeros((n, 3))
    torque = np.zeros((n, 3))
    for nr1 in range(n):
        for nr2 in range(n):
            if not (ids[nr2] - ids[nr1] > 1):   # each unordered pair once
                continue
            t1, t2 = affines[nr1, 0:3], affines[nr2, 0:3]
            for x1 in atoms[nr1]:
                for x2 in atoms[nr2]:
                    r = x1 - x2
                    r2 = r @ r
                    if r2 > 3.0 * 3.0 + 0.1 * 3.0:   # :16
                        continue
                    v, dv = _ref_compact_sigmoid(r2 - 9.0, 1.0 / 0.3)
                    pot += 4.0 * v
                    g = 2.0 * 4.0 * dv * r           # deriv_over_r * r
                    d[nr1] += g
                    torque[nr1] += np.cross(x1 - t1, g)
                    d[nr2] -= g
                    torque[nr2] += np.cross(x2 - t2, -g)
    return pot, d, torque


def _ref_radial_edge(p, x1, x2):
    """RadialHelper::compute_edge (src/sidechain_radial.cpp:47-62):
    clamped deBoor of dist2*rsqrt(dist2+1e-7)*inv_dx over 16 knots;
    p = [inv_dx, 16 knot coeffs]."""
    x1, x2 = np.asarray(x1, np.float64), np.asarray(x2, np.float64)
    inv_dx = p[0]
    disp = x1 - x2
    dist2 = disp @ disp
    n_knot = 16
    cutoff = (n_knot - 2 - 1e-6) / inv_dx   # sidechain_radial.cpp:33-36
    if dist2 >= cutoff * cutoff:
        return 0.0  # the interaction graph never evaluates this pair
    inv_dist = 1.0 / np.sqrt(dist2 + 1e-7)
    dist_coord = dist2 * inv_dist * inv_dx
    v, _ = _ref_clamped_deboor(p[1:], dist_coord, n_knot)
    return v


def _ref_integration_cycle(pos, mom, dt, integrator, max_force, deriv_fn):
    """DerivEngine::integration_cycle + integration_stage
    (src/deriv_engine.cpp:11-35, 172-192): three stages of
    mom -= dt*mom_w[s]*clip(deriv); pos += dt*pos_w[s]*mom, with the
    Predescu-2012 or Verlet stage weights and atan force clipping."""
    pos = np.asarray(pos, np.float64).copy()
    mom = np.asarray(mom, np.float64).copy()
    a, b = ((0.108991425403425322, 0.290485609075128726)
            if integrator == "predescu" else (1.0 / 6.0, 1.0 / 3.0))
    mom_w = [1.5 - 3 * a, 1.5 - 3 * a, 6 * a]
    pos_w = [3 * b, 3.0 - 6 * b, 3 * b]
    for s in range(3):
        d = np.asarray(deriv_fn(pos), np.float64)
        if max_force:
            f_mag = np.sqrt(np.sum(d * d, -1, keepdims=True)) + 1e-6
            d = d * (np.arctan(f_mag * (0.5 * np.pi / max_force))
                     * (max_force / f_mag * (2.0 / np.pi)))
        mom = mom - dt * mom_w[s] * d
        pos = pos + dt * pos_w[s] * mom
    return pos, mom


def _golden_deriv(pos):
    """Toy anisotropic-spring derivative used by the integrator goldens —
    pure math, written once and shared by generator and repo test."""
    k = np.asarray([1.3, 0.4, 2.1])
    return k * np.asarray(pos) + 0.2 * np.asarray(pos) ** 2


# ---------------------------------------------------------------------------
# Pinned inputs and committed golden literals
# ---------------------------------------------------------------------------

CS_GOLDEN = [  # (x, sharpness, value, deriv)
    (-5.0, 0.25, 1.0, 0.0),
    (-2.0, 0.5, 1.0, 0.0),
    (0.0, 0.7, 0.5, -0.5249999999999999),
    (0.3, 2.0, 0.10400000000000001, -0.96),
    (0.9, 1.0, 0.007249999999999997, -0.14249999999999996),
    (1.5, 0.5, 0.04296875, -0.1640625),
    (3.0, 0.5, 0.0, 0.0),
]

ENV_P = [6.0, 0.5, 0.4, 2.0]   # r0, r_sharpness, dot0, dot_sharpness
ENV_GOLDEN = [  # (cb (6,), sc (4,), value, d_cb (6,), d_sc (4,))
    # angular gate saturated (dot0 - dp < -1/sharpness): pure radial edge
    ([0.0, 0.0, 0.0, 0.6, 0.8, 0.0],
     [3.0, 4.0, 1.0, 0.7],
     0.5705083269007444,
     [0.12309888189086114, 0.16413184252114818, 0.041032960630287045,
      0.0, 0.0, 0.0],
     [-0.12309888189086114, -0.16413184252114818, -0.041032960630287045,
      0.815011895572492]),
    ([1.0, -2.0, 0.5, 0.0, 0.0, 1.0],
     [5.0, 1.0, 2.0, 1.0],
     0.25963309040438487,
     [0.12805534245662997, 0.09604150684247247, -0.16408448459843752,
      0.8484209520786951, 0.6363157140590213, 0.31815785702951066],
     [-0.12805534245662997, -0.09604150684247247, 0.16408448459843752,
      0.25963309040438487]),
    # axis-aligned displacement: only the y components are live
    ([0.5, 0.5, 0.5, 0.0, 1.0, 0.0],
     [0.5, 7.4, 0.5, 0.55],
     0.1019046874999998,
     [0.0, 0.1644843749999999, 0.0, 0.0, 0.0, 0.0],
     [0.0, -0.1644843749999999, 0.0, 0.18528124999999962]),
]

# periodic grid: PER2D_DATA[ix, iy] = sin(2 pi ix / 6) + cos(2 pi (ix+2 iy) / 8)
PER2D_NX, PER2D_NY = 6, 8
PER2D_DATA = [[float(np.sin(2 * np.pi * ix / 6)
                     + np.cos(2 * np.pi * (ix + 2 * iy) / 8))
               for iy in range(8)] for ix in range(6)]
PER2D_GOLDEN = [  # (x, y, value, d/dx, d/dy)
    (0.3, 0.7, 0.5719067486239527, 0.2850190735027419, -1.7309788192277331),
    (2.6, 5.2, -0.2961588683890828, -0.4027759767249708, 1.1314074063602628),
    (5.9, 7.9, 0.7577412505968065, 2.4448968583621937, 0.39468654290050104),
    # exact knot: the fit must interpolate PER2D_DATA[4][0]
    (4.0, 0.0, -1.8660254037844382, -0.7196152422706632, 0.0),
]

CLAMP_DATA = [0.4, -1.3, 2.2, 0.9, -0.5, 0.05, 1.7, -2.0, 0.3]
CLAMP_GOLDEN = [  # (x, value, deriv)
    (-0.5, 0.4, 0.0),
    (0.0, 0.4, 0.0),
    (0.35, -0.1459694990335051, -2.600257248711341),
    (3.8, -0.3515625920471279, -0.8752190721649491),
    (7.3, -1.5850553479381448, 2.8590212628865963),
    (7.999, 0.2999925483177366, 0.014898207685937748),
    (8.0, 0.3, 0.0),
    (9.5, 0.3, 0.0),
]

MEM_CB_ENERGY = [[0.0, 1.5, 2.5, 1.0, -0.5, 0.2, 0.0],
                 [0.3, -0.8, -1.9, -0.6, 0.9, 0.4, 0.1]]
MEM_UHB_ENERGY = [[0.0, 0.7, 1.8, 0.9, 0.1],
                  [0.2, 1.1, 2.3, 1.2, 0.0]]
MEM_INPUTS = dict(
    cb_z=[-4.0, 1.3, 7.9], restype=[0, 1, 0], cov=[2.0, 6.5, 11.0],
    cov_mid=[4.0, 7.0], cov_sharp=[0.25, 0.5],
    cb_z_shift=15.0, cb_z_scale=6.0 / 30.0,
    uhb_z_shift=15.0, uhb_z_scale=4.0 / 30.0,
    hb_z=[-2.0, 3.5, 9.0], hb_prob=[0.1, 0.85, 0.4], n_donor=2)
MEM_GOLDEN = 3.6190594791380497  # total potential

RAD_P = [1.2,                                         # inv_dx
         3.1, 3.1, 2.2, 1.4, 0.7, 0.15, -0.2, -0.35,  # 16 knots
         -0.3, -0.18, -0.08, -0.02, 0.01, 0.0, 0.0, 0.0]
RAD_GOLDEN = [  # (x1, x2, energy)
    ([0.0, 0.0, 0.0], [1.5, 2.0, 0.0], 1.4166666846666667),
    # near-contact: left boundary value of the clamped spline
    ([1.0, 1.0, 1.0], [1.2, 1.3, 1.4], 2.95),
    ([0.0, 0.0, 0.0], [6.0, 6.0, 6.0], 0.004478010227335199),
    # beyond (n_knot-2-1e-6)/inv_dx: masked to zero
    ([0.0, 0.0, 0.0], [12.0, 0.0, 0.0], 0.0),
]

# backbone steric: 3 residues, ids with one adjacent exclusion (2,3);
# quaternions are exactly unit by construction
STERIC_IDS = [0, 2, 3]
STERIC_N_ATOM = [4, 3, 4]
STERIC_AFFINES = [
    [0.0, 0.0, 0.0,      1.0, 0.0, 0.0, 0.0],
    # two atom pairs inside the (2.95, 3.05) sigmoid band, two saturated
    [3.45, 0.42, -0.22,  0.5, 0.5, 0.5, 0.5],
    # one band pair vs residue 0; its band pair vs residue 1 is EXCLUDED
    # by the (2,3) id gap — a broken exclusion would shift every literal
    [2.1, -3.12, 0.84,   0.8, 0.2, -0.4, 0.4],
]
STERIC_REF_POS = [
    [[0.9, 0.0, 0.0], [0.0, 0.9, 0.0], [0.0, 0.0, 0.9], [-0.6, -0.6, 0.3]],
    [[1.1, 0.2, 0.0], [-0.4, 0.8, 0.3], [0.0, -0.7, -0.6], [0.0, 0.0, 0.0]],
    [[0.8, 0.4, -0.2], [-0.9, 0.1, 0.5], [0.3, -0.8, 0.1], [-0.2, 0.6, 0.7]],
]
INTG_POS = [[0.3, -0.8, 0.5], [-0.4, 0.9, -0.2]]
INTG_MOM = [[0.1, 0.05, -0.2], [0.0, -0.15, 0.3]]
INTG_DT = 0.009
INTG_GOLDEN = {  # integrator (or (integrator, max_force)) -> (pos, mom)
    'verlet': ([[0.3025013168741639, -0.7985567001894053,
                 0.49406682393322543],
                [-0.399762850250019, 0.8956966532408723,
                 -0.1917015630564987]],
               [[0.08895117812877677, 0.05518298120921166,
                 -0.2295808831435232],
                [0.013174377780206647, -0.1640651596227555,
                 0.3109742554292606]]),
    'predescu': ([[0.3024820198961235, -0.798547588006583,
                   0.49401442118497824],
                  [-0.39973969403531656, 0.895671833186518,
                   -0.19168174257478068]],
                 [[0.08895783135939213, 0.05518317371805781,
                   -0.22960307790013534],
                  [0.013174460417148919, -0.16407062390811403,
                   0.3110031475793298]]),
    ('verlet', 0.5): ([[0.3026302399742287, -0.7986172433814508,
                        0.49441278995709936],
                       [-0.3998897276804244, 0.8958321982290508,
                        -0.19180772782484393]],
                      [[0.09611739010738989, 0.05182114469924304,
                        -0.21039539917264596],
                       [0.00613220761481348, -0.15654666587910887,
                        0.30510825807502473]]),
}

# OU thermostat scales (thermostat.h:9-12): mom_scale = exp(-dt/tau),
# noise_scale = sqrt(T*(1-mom_scale^2))
OU_CASES = [  # (timescale, delta_t, temp, mom_scale, noise_scale)
    (5.0, 0.027, 0.85, 0.9946145537913912, 0.09555420439938277),
    # the reference thermalizes initial momenta with delta_t = 1e8:
    # a pure Maxwell-Boltzmann draw (main.cpp:515-522)
    (1.0, 1e8, 1.0, 0.0, 1.0),
    (20.0, 0.009, 0.5, 0.9995501012348142, 0.021208431359634315),
]

STERIC_GOLDEN = (             # (potential, d (3,3), torque (3,3))
    13.385035526223998,
    [
        [87.53039246720058, -32.52137474417761, 15.770615550222166],
        [-63.09145200000057, -13.262969422222403, 10.524446977777847],
        [-24.438940467200016, 45.78434416640002, -26.295062528000013],
    ],
    [
        [-9.25142984000006, -23.44498383520001, -53.10172500976002],
        [7.749015382222293, 22.208650193333447, 31.154649926667044],
        [-43.58174598758403, -11.025365041152009, 21.30828125798402],
    ],
)


# ---------------------------------------------------------------------------
# Generator self-checks: transliterations reproduce the committed literals
# ---------------------------------------------------------------------------

def test_generator2_matches_literals():
    for x, s, v, d in CS_GOLDEN:
        gv, gd = _ref_compact_sigmoid(x, s)
        np.testing.assert_allclose([gv, gd], [v, d], rtol=1e-13, atol=1e-15)
    for cb, sc, v, dcb, dsc in ENV_GOLDEN:
        gv, gdcb, gdsc = _ref_env_edge(ENV_P, cb, sc)
        np.testing.assert_allclose(gv, v, rtol=1e-13)
        np.testing.assert_allclose(gdcb, dcb, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(gdsc, dsc, rtol=1e-12, atol=1e-15)
    coeff2d = _ref_solve_periodic_2d(PER2D_DATA)
    for x, y, v, dx, dy in PER2D_GOLDEN:
        gv, gdx, gdy = _ref_eval_periodic_2d(coeff2d, x, y)
        np.testing.assert_allclose([gv, gdx, gdy], [v, dx, dy],
                                   rtol=1e-12, atol=1e-14)
    ccl = _ref_solve_clamped_1d(CLAMP_DATA)
    for x, v, d in CLAMP_GOLDEN:
        gv, gd = _ref_eval_clamped_1d(ccl, CLAMP_DATA, x)
        np.testing.assert_allclose([gv, gd], [v, d], rtol=1e-12, atol=1e-14)
    gm = _ref_membrane(MEM_CB_ENERGY, MEM_UHB_ENERGY, **MEM_INPUTS)
    np.testing.assert_allclose(gm, MEM_GOLDEN, rtol=1e-13)
    for x1, x2, v in RAD_GOLDEN:
        np.testing.assert_allclose(_ref_radial_edge(RAD_P, x1, x2), v,
                                   rtol=1e-12, atol=1e-15)
    gp, gd, gt = _ref_backbone_pairs(STERIC_AFFINES, STERIC_REF_POS,
                                     STERIC_N_ATOM, STERIC_IDS)
    np.testing.assert_allclose(gp, STERIC_GOLDEN[0], rtol=1e-13)
    np.testing.assert_allclose(gd, STERIC_GOLDEN[1], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(gt, STERIC_GOLDEN[2], rtol=1e-12, atol=1e-15)
    for key, (ep, em) in INTG_GOLDEN.items():
        integ, mf = key if isinstance(key, tuple) else (key, 0.0)
        gp2, gm2 = _ref_integration_cycle(INTG_POS, INTG_MOM, INTG_DT,
                                          integ, mf, _golden_deriv)
        np.testing.assert_allclose(gp2, ep, rtol=1e-13)
        np.testing.assert_allclose(gm2, em, rtol=1e-13)
    for tau, dlt, temp, ms, ns in OU_CASES:
        gms = np.exp(-dlt / tau)
        np.testing.assert_allclose(gms, ms, rtol=1e-13)
        np.testing.assert_allclose(np.sqrt(temp * (1 - gms * gms)), ns,
                                   rtol=1e-13)


# ---------------------------------------------------------------------------
# Repo kernels vs the golden literals
# ---------------------------------------------------------------------------

def test_compact_sigmoid_vs_golden():
    for x, s, v, d in CS_GOLDEN:
        gv, gd = compact_sigmoid(jnp.asarray(x, jnp.float64),
                                 jnp.asarray(s, jnp.float64))
        np.testing.assert_allclose([float(gv), float(gd)], [v, d],
                                   rtol=1e-12, atol=1e-14)
    # the spline interpolation property the periodic fit must satisfy is
    # checked in test_periodic_2d_vs_golden below


def _env_node_value(cb_row, sc_row):
    consts = {"index1": np.array([0]), "index2": np.array([0]),
              "type1": np.array([0]), "type2": np.array([0]),
              "id1": np.array([0]), "id2": np.array([10])}
    params = {"interaction_param": jnp.asarray(
        np.asarray(ENV_P, np.float64).reshape(1, 1, 4))}
    out = _environment_coverage(consts, params, (cb_row[None], sc_row[None]),
                                {})
    return out[0, 0]


def test_environment_edge_vs_golden():
    for cb, sc, v, dcb, dsc in ENV_GOLDEN:
        cbj = jnp.asarray(cb, jnp.float64)
        scj = jnp.asarray(sc, jnp.float64)
        got = float(_env_node_value(cbj, scj))
        np.testing.assert_allclose(got, v, rtol=1e-10)
        g_cb, g_sc = jax.grad(_env_node_value, argnums=(0, 1))(cbj, scj)
        np.testing.assert_allclose(np.asarray(g_cb), dcb,
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(g_sc), dsc,
                                   rtol=1e-9, atol=1e-12)


def test_periodic_2d_vs_golden():
    """fit_periodic_bspline_2d + eval_periodic_bspline_2d — the Rama-map
    evaluation pipeline (nodes/rama.py) — against the reference power-basis
    construction."""
    coeffs = jnp.asarray(fit_periodic_bspline_2d(np.asarray(PER2D_DATA)))
    for x, y, v, dx, dy in PER2D_GOLDEN:
        gv, gdx, gdy = eval_periodic_bspline_2d(
            coeffs, jnp.asarray([x], jnp.float64),
            jnp.asarray([y], jnp.float64))
        np.testing.assert_allclose(
            [float(gv[0]), float(gdx[0]), float(gdy[0])], [v, dx, dy],
            rtol=1e-9, atol=1e-12)


def test_clamped_interp_vs_golden():
    coeffs = jnp.asarray(fit_clamped_interp_bspline(np.asarray(CLAMP_DATA)))
    for x, v, d in CLAMP_GOLDEN:
        gv, gd = eval_clamped_interp(coeffs, jnp.asarray(x, jnp.float64))
        np.testing.assert_allclose([float(gv), float(gd)], [v, d],
                                   rtol=1e-9, atol=1e-12)


def test_membrane_potential_vs_golden():
    mi = MEM_INPUTS
    n_res = len(mi["cb_z"])
    cb_pos = np.zeros((n_res, 3))
    cb_pos[:, 2] = mi["cb_z"]
    env_cov = np.asarray(mi["cov"])[:, None]
    n_hb = len(mi["hb_z"])
    hbond = np.zeros((n_hb, 7))
    hbond[:, 2] = mi["hb_z"]
    hbond[:, 6] = mi["hb_prob"]
    consts = {
        "residue_type": np.asarray(mi["restype"]),
        "cb_index": np.arange(n_res), "env_index": np.arange(n_res),
        "cov_midpoint": jnp.asarray(mi["cov_mid"], jnp.float64),
        "cov_sharpness": jnp.asarray(mi["cov_sharp"], jnp.float64),
        "cb_z_shift": mi["cb_z_shift"], "cb_z_scale": mi["cb_z_scale"],
        "uhb_z_shift": mi["uhb_z_shift"], "uhb_z_scale": mi["uhb_z_scale"],
        "n_donor": mi["n_donor"],
    }
    # fit in float64 (make_membrane_params itself rounds to f32 for the
    # device tables; the f32 round-off is ~2e-9 relative)
    params = {
        "cb_coeff": jnp.asarray(fit_clamped_interp_bspline(
            np.asarray(MEM_CB_ENERGY, np.float64))),
        "uhb_coeff": jnp.asarray(fit_clamped_interp_bspline(
            np.asarray(MEM_UHB_ENERGY, np.float64))),
    }
    # and the production f32 path agrees to f32 round-off
    params32 = make_membrane_params(MEM_CB_ENERGY, MEM_UHB_ENERGY)
    for k in params:
        np.testing.assert_allclose(np.asarray(params32[k], np.float64),
                                   np.asarray(params[k]), rtol=1e-6)
    pot = _membrane_potential(consts, params,
                              (jnp.asarray(cb_pos), jnp.asarray(env_cov),
                               jnp.asarray(hbond)), {})
    np.testing.assert_allclose(float(pot), MEM_GOLDEN, rtol=1e-9)


def test_radial_edge_vs_golden():
    p = jnp.asarray(np.asarray(RAD_P, np.float64).reshape(1, 1, 17))
    mask = jnp.ones((1, 1), bool)
    for x1, x2, v in RAD_GOLDEN:
        en = _radial_energy(p, jnp.asarray([x1], jnp.float64),
                            jnp.asarray([x2], jnp.float64), mask)
        np.testing.assert_allclose(float(en[0, 0]), v, rtol=1e-9, atol=1e-12)


def test_integration_cycle_vs_golden():
    from upside_md.md.integrator import integration_cycle

    def deriv_fn(p, stage):
        k = jnp.asarray([1.3, 0.4, 2.1], p.dtype)
        return k * p + 0.2 * p * p

    for key, (ep, em) in INTG_GOLDEN.items():
        integ, mf = key if isinstance(key, tuple) else (key, 0.0)
        pos, mom = integration_cycle(
            deriv_fn, jnp.asarray(INTG_POS, jnp.float64),
            jnp.asarray(INTG_MOM, jnp.float64), INTG_DT,
            max_force=mf, integrator=integ)
        np.testing.assert_allclose(np.asarray(pos), ep, rtol=1e-11)
        np.testing.assert_allclose(np.asarray(mom), em, rtol=1e-11)


def test_ou_thermostat_vs_golden():
    from upside_md.md.thermostat import OUThermostat
    for tau, dlt, temp, ms, ns in OU_CASES:
        th = OUThermostat(tau, dlt)
        np.testing.assert_allclose(float(th.mom_scale), ms, rtol=1e-12)
        np.testing.assert_allclose(
            float(th.noise_scale(jnp.asarray(temp, jnp.float64))), ns,
            rtol=1e-12)


def _steric_consts():
    ref_pos = np.zeros((3, 4, 3))
    for nr, row in enumerate(STERIC_REF_POS):
        ref_pos[nr, :len(row)] = row
    atom_mask = (np.arange(4)[None, :]
                 < np.asarray(STERIC_N_ATOM)[:, None])
    return {"id": np.asarray(STERIC_IDS), "ref_pos": ref_pos,
            "atom_mask": atom_mask}


def _steric_energy(aff_input):
    from upside_md.nodes.steric import _backbone_pairs
    return _backbone_pairs(_steric_consts(), {}, (aff_input,), {})


def _quat_mul_pure(i, q):
    """(0, e_i) x (a, v) quaternion product (Hamilton, [a,b,c,d])."""
    e = np.zeros(3)
    e[i] = 1.0
    a, v = q[0], np.asarray(q[1:4])
    return np.concatenate([[-e @ v], a * e + np.cross(e, v)])


def test_backbone_pairs_vs_golden():
    """Value, translation gradient, and the torque identity: the
    reference accumulates (force, torque) on the 7-wide affine output
    (backbone_steric.cpp:135-143); the repo differentiates through
    quat_to_rot, so dE/dtheta_i = 0.5 * dE/dq . (e_i x q) must equal the
    reference torque."""
    # the node indexes its input BY residue id (rows 0, 2, 3 live)
    aff = np.zeros((max(STERIC_IDS) + 1, 7))
    for nr, row in enumerate(STERIC_AFFINES):
        aff[STERIC_IDS[nr]] = row
    affj = jnp.asarray(aff, jnp.float64)

    pot = float(_steric_energy(affj))
    np.testing.assert_allclose(pot, STERIC_GOLDEN[0], rtol=1e-9)

    g = np.asarray(jax.grad(_steric_energy)(affj))
    for nr in range(3):
        row = g[STERIC_IDS[nr]]
        np.testing.assert_allclose(row[0:3], STERIC_GOLDEN[1][nr],
                                   rtol=1e-8, atol=1e-12)
        q = np.asarray(STERIC_AFFINES[nr][3:7])
        torque = [0.5 * row[3:7] @ _quat_mul_pure(i, q) for i in range(3)]
        np.testing.assert_allclose(torque, STERIC_GOLDEN[2][nr],
                                   rtol=1e-8, atol=1e-12)
