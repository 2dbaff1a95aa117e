"""Cross-implementation golden fixtures derived from the reference C++.

Every expected literal in this file was produced by hand-evaluating the
reference kernel FORMULAS (transliterated below, in float64, independent of
any repo kernel code) at pinned inputs — NOT by running repo kernels.  The
transliterations cite their C++ sources line by line; `test_generator_*`
pins the transliteration itself to the committed literals so neither side
can drift silently, and the remaining tests pin the repo kernels to the
same literals.

Covered formulas (VERDICT round-2 missing item 1):
  * de Boor B-spline value+deriv            src/spline.h:97-128
  * clamped de Boor boundary values         src/spline.h:255-310
  * directional bead quadspline + analytic
    derivative partition                    src/bead_interaction.h:30-84
  * protein hbond pair strength (sigmoid
    products, angular gates, log space)     src/hbond.cpp:124-230
  * Bethe node/edge free-energy terms       src/rotamer.cpp:292-302,431-451
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from upside_md.nodes.hbond import hbond_pair_strength
from upside_md.nodes.rotamer import EPS, bethe_free_energy
from upside_md.ops.pairs import quadspline_coverage
from upside_md.ops.spline import eval_bspline, eval_clamped_bspline

# ---------------------------------------------------------------------------
# Reference-formula transliterations (float64; no repo kernel code)
# ---------------------------------------------------------------------------


def _ref_deboor(coeff, x):
    """deBoor_value_and_deriv (src/spline.h:97-128): the SSE lane algebra
    transliterated with right_rotate(v)[i] = v[i-1 mod 4]
    (src/Float4.h:239).  Returns (value, deriv)."""
    b = int(np.floor(x))
    y = x - b
    c0 = np.array(coeff[b - 1:b + 3], np.float64)
    yu = y - np.array([0.0, -2.0, -1.0, 0.0])     # spline.h:109-110

    def rot(v):
        return np.roll(v, 1)

    c1 = (1 - yu / 3.0) * rot(c0) + (yu / 3.0) * c0
    c2 = (1 - yu / 2.0) * rot(c1) + (yu / 2.0) * c1
    c3 = (1 - yu) * rot(c2) + yu * c2
    d1 = c0 - rot(c0)
    d2 = (1 - yu / 2.0) * rot(d1) + (yu / 2.0) * d1
    d3 = (1 - yu) * rot(d2) + yu * d2
    return c3[3], d3[3]


def _ref_clamped_deboor(coeff, x, n_knot):
    """clamped_deBoor_value_and_deriv (src/spline.h:264-272) with the
    boundary stencils of spline.h:247-262."""
    if x <= 1.0:
        return coeff[0] / 6 + 2 * coeff[1] / 3 + coeff[2] / 6, 0.0
    if x >= n_knot - 2:
        return (coeff[n_knot - 3] / 6 + 2 * coeff[n_knot - 2] / 3
                + coeff[n_knot - 1] / 6), 0.0
    return _ref_deboor(coeff, x)


def _ref_quadspline(ka, k, inv_dx, p, x1, x2):
    """quadspline (src/bead_interaction.h:30-84) incl. the analytic
    derivative partition (:61-81).  Returns (coverage, d1, d2)."""
    inv_dtheta = (ka - 3) / 2.0
    x1, x2 = np.asarray(x1, np.float64), np.asarray(x2, np.float64)
    displace = x2[0:3] - x1[0:3]
    rvec1, rvec2 = x1[3:6], x2[3:6]
    dist2 = displace @ displace
    inv_dist = 1.0 / np.sqrt(dist2)
    dist_coord = dist2 * inv_dist * inv_dx
    uvec = inv_dist * displace
    cos1 = rvec1 @ uvec
    cos2 = rvec2 @ (-uvec)

    a1v, a1d = _ref_deboor(p[0:ka], (cos1 + 1) * inv_dtheta + 1)
    a2v, a2d = _ref_deboor(p[ka:2 * ka], (cos2 + 1) * inv_dtheta + 1)
    wv, wd = _ref_clamped_deboor(p[2 * ka:2 * ka + k], dist_coord, k)
    nv, nd = _ref_clamped_deboor(p[2 * ka + k:2 * ka + 2 * k], dist_coord, k)

    angular_weight = a1v * a2v
    radial_deriv = inv_dx * (wd + angular_weight * nd)
    ang_d1 = inv_dtheta * a1d * a2v * nv
    ang_d2 = inv_dtheta * a1v * a2d * nv
    rXX = ang_d1 * rvec1 - ang_d2 * rvec2
    deriv_dir = inv_dist * (rXX - (uvec @ rXX) * uvec)
    d_displace = radial_deriv * uvec + deriv_dir
    coverage = wv + angular_weight * nv
    return (coverage,
            np.concatenate([-d_displace, ang_d1 * uvec]),
            np.concatenate([d_displace, -ang_d2 * uvec]))


def _ref_sigmoid(x):
    """vector_math.h:626-631: 1/(1+exp(-x)); deriv z*w^2."""
    z = np.exp(-x)
    w = 1.0 / (1.0 + z)
    return w, z * w * w


def _ref_hbond_edge(p, x1, x2):
    """ProteinHBondInteraction::compute_edge (src/hbond.cpp:166-230) with
    hbond_radial_potential / hbond_angular_potential (:128-148),
    angular_cutoff = 0 (:126).  Returns (hb, hb_log)."""
    x1, x2 = np.asarray(x1, np.float64), np.asarray(x2, np.float64)
    H, rHN = x1[0:3], x1[3:6]
    O, rOC = x2[0:3], x2[3:6]
    HO = H - O
    mag2 = HO @ HO + 1e-6                         # hbond.cpp:177
    inv_mag = 1.0 / np.sqrt(mag2)
    magHO = mag2 * inv_mag
    rHO = HO * inv_mag
    dotHOC = rHO @ rOC
    dotOHN = -(rHO @ rHN)
    if not (dotHOC > 0.0 and dotOHN > 0.0):       # hbond.cpp:188-191
        hb = 0.0
    else:
        outer, _ = _ref_sigmoid((p[2] - magHO) * p[3])   # hbond.cpp:134
        inner, _ = _ref_sigmoid((magHO - p[0]) * p[1])   # hbond.cpp:135
        ang1, _ = _ref_sigmoid((dotHOC - p[4]) * p[5])   # hbond.cpp:146
        ang2, _ = _ref_sigmoid((dotOHN - p[4]) * p[5])
        hb = outer * inner * ang1 * ang2                  # hbond.cpp:209
    hb_log = 100.0 if hb >= 1.0 else -np.log(1.0 - hb)   # hbond.cpp:221
    return hb, hb_log


def _ref_node_free_energy(belief, prob, offset):
    """NodeHolder::node_free_energy (src/rotamer.cpp:292-302)."""
    b = np.asarray(belief, np.float64)
    b = b / b.sum()
    pr = np.asarray(prob, np.float64)
    en = offset
    for no in range(len(b)):
        en += b[no] * np.log((1e-10 + b[no]) / (1e-10 + pr[no]))
    return en


def _ref_edge_free_energy(marg, prob, b1, b2):
    """EdgeHolder::edge_free_energy (src/rotamer.cpp:431-451)."""
    p = np.asarray(marg, np.float64)
    pr = np.asarray(prob, np.float64)
    en = 0.0
    for i in range(p.shape[0]):
        for j in range(p.shape[1]):
            en += p[i, j] * np.log((1e-10 + p[i, j]) /
                                   (1e-10 + pr[i, j] * b1[i] * b2[j]))
    return en


# ---------------------------------------------------------------------------
# Pinned inputs and committed golden literals
# ---------------------------------------------------------------------------

C9 = [0.17, -0.62, 0.44, 1.9, -1.2, 0.33, -0.48, 0.95, 0.27]
CLAMPED_GOLDEN = [  # (x, value, deriv), n_knot = 9
    (0.3, -0.31166666666666665, 0.0),
    (1.0, -0.31166666666666665, 0.0),
    (1.25, -0.22388020833333333, 0.5521875),
    (2.7, 1.2031200000000002, 0.3247999999999994),
    (4.5, -0.3872916666666666, 0.65875),
    (6.3, 0.06755833333333326, 0.7862499999999999),
    (6.999, 0.5979572790583332, 0.3771078250000007),
    (7.0, 0.5983333333333334, 0.0),
    (8.5, 0.5983333333333334, 0.0),
]

C8 = [0.05, 0.85, 1.3, 0.9, 0.15, -0.4, -0.1, 0.6]
UNCLAMPED_GOLDEN = [  # (x, value, deriv), n_knot = 8
    (1.0, 0.7916666666666667, 0.625),
    (1.25, 0.9356770833333333, 0.5218750000000001),
    (3.7, 0.3848583333333332, -0.6852499999999999),
    (5.99, -0.03831325833333321, 0.49597750000000007),
]

QS_KA, QS_K, QS_INV_DX = 8, 9, 1.0   # default SC_SC family
QS_PARAMS = np.array(
    [0.05, 0.85, 1.3, 0.9, 0.15, -0.4, -0.1, 0.6,           # angular 1
     0.3, 1.1, 0.7, 0.2, -0.25, 0.45, 0.9, -0.15,           # angular 2
     2.8, 2.8, 1.9, 0.85, 0.3, 0.05, -0.12, 0.0, -0.12,     # wide cover
     1.5, 1.5, 1.1, 0.6, 0.2, -0.3, -0.45, -0.2, -0.45])    # narrow cover
QS_GOLDEN = [  # (x1, x2, coverage, d1, d2)
    ([0.3, -0.2, 0.1, 0.6, 0.8, 0.0],
     [2.7, 1.9, -0.4,
      -0.5011036433614473, 0.2004414573445789, 0.8418541208472314],
     0.7603405011281104,
     [0.5170049558060373, 0.43884811648152316, -0.12032719703259868,
      0.0374254276321267, 0.03274724917811086, -0.007796964090026394],
     [-0.5170049558060373, -0.43884811648152316, 0.12032719703259868,
      0.03472012357642864, 0.03038010812937506, -0.007233359078422632]),
    ([0.0, 0.0, 0.0, 1.0, 0.0, 0.0],
     [6.2, 0.5, 0.8,
      -0.9091372900969896, -0.10101525445522108, 0.4040610178208843],
     -0.058165281001897995,
     [-0.028865874919405222, -0.006126128577554716, -0.009186391014172016,
      -0.2896917437411978, -0.023362237398483695, -0.03737957983757391],
     [0.028865874919405222, 0.006126128577554716, 0.009186391014172016,
      -0.006745040676659924, -0.0005439548932790261, -0.0008703278292464416]),
    # near-contact pair: distance below 1 -> left clamp of both distance
    # splines (zero radial derivative, live angular derivative)
    ([0.1, 0.0, 0.2, 0.0, 1.0, 0.0],
     [0.6, 0.5, 0.0,
      0.2996257016633534, -0.6991266372144912, 0.649189020270599],
     2.5791071119929603,
     [-0.43270499556389325, 0.27402608912981696, -0.39669726608519057,
      0.016620992919864335, 0.016620992919864335, -0.006648397167945734],
     [0.43270499556389325, -0.27402608912981696, 0.39669726608519057,
      0.3704487297445736, 0.3704487297445736, -0.14817949189782945]),
]

HB_PARAMS = np.array([1.4, 2.5, 2.5, 1.25, 0.18, 10.0, 0.0, 0.0])
HB_GOLDEN = [  # (x1 = H+rHN, x2 = O+rOC, hb, hb_log)
    ([0.0, 0.0, 0.0,
      0.09938079899999067, 0.9938079899999066, -0.04969039949999533],
     [0.1, 2.0, 0.0,
      -0.14762034939153687, -0.9841356626102459, 0.0984135662610246],
     0.5322449411644807, 0.7598104986314375),
    ([0.0, 0.0, 0.0, 0.8, 0.6, 0.0],
     [0.0, 2.2, 0.0, 0.3011313679370974, -0.9535826651341417, 0.0],
     0.5140820565893779, 0.7217155100557267),
    # angular gate closed: dotHOC < 0 kills the pair entirely
    ([0.0, 0.0, 0.0, 0.0, 1.0, 0.0],
     [0.0, 2.0, 0.0, 0.0, 1.0, 0.0],
     0.0, 0.0),
    ([0.0, 0.0, 0.0, 0.0, 1.0, 0.0],
     [0.0, 3.4, 0.0, 0.0, -1.0, 0.0],
     0.2433109916148187, 0.27880293111045734),
]

BETHE_B = [[0.2, 0.5, 0.3], [0.5, 0.3, 0.2]]
BETHE_PR = [[0.15, 0.6, 0.25], [1.0, 0.8, 0.001]]
BETHE_OFF = [0.37, -1.2]
BETHE_P = np.array([[0.9, 0.5, 0.1], [0.4, 1.0, 0.3], [0.05, 0.2, 0.8]])
BETHE_NODE_GOLDEN = [0.3910721030948986, -0.7811589126613823]
BETHE_EDGE_GOLDEN = 0.8520237157280157


# ---------------------------------------------------------------------------
# Generator self-checks: transliteration reproduces the committed literals
# ---------------------------------------------------------------------------

def test_generator_matches_literals():
    for x, v, d in CLAMPED_GOLDEN:
        gv, gd = _ref_clamped_deboor(C9, x, 9)
        np.testing.assert_allclose([gv, gd], [v, d], rtol=1e-13, atol=1e-13)
    for x, v, d in UNCLAMPED_GOLDEN:
        gv, gd = _ref_deboor(C8, x)
        np.testing.assert_allclose([gv, gd], [v, d], rtol=1e-13, atol=1e-13)
    for x1, x2, cov, d1, d2 in QS_GOLDEN:
        gc, gd1, gd2 = _ref_quadspline(QS_KA, QS_K, QS_INV_DX, QS_PARAMS,
                                       x1, x2)
        np.testing.assert_allclose(gc, cov, rtol=1e-13)
        np.testing.assert_allclose(gd1, d1, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(gd2, d2, rtol=1e-12, atol=1e-14)
    for x1, x2, hb, hbl in HB_GOLDEN:
        ghb, ghbl = _ref_hbond_edge(HB_PARAMS, x1, x2)
        np.testing.assert_allclose([ghb, ghbl], [hb, hbl],
                                   rtol=1e-13, atol=1e-13)
    for i in range(2):
        gn = _ref_node_free_energy(BETHE_B[i], BETHE_PR[i], BETHE_OFF[i])
        np.testing.assert_allclose(gn, BETHE_NODE_GOLDEN[i], rtol=1e-13)
    ge = _ref_edge_free_energy(BETHE_P / BETHE_P.sum(), BETHE_P,
                               BETHE_B[0], BETHE_B[1])
    np.testing.assert_allclose(ge, BETHE_EDGE_GOLDEN, rtol=1e-13)


# ---------------------------------------------------------------------------
# Repo kernels vs the golden literals
# ---------------------------------------------------------------------------

def test_clamped_spline_vs_golden():
    coeffs = jnp.asarray(C9)
    for x, v, d in CLAMPED_GOLDEN:
        val, der = eval_clamped_bspline(coeffs, jnp.asarray(x))
        np.testing.assert_allclose(float(val), v, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(der), d, rtol=1e-10, atol=1e-12)


def test_unclamped_spline_vs_golden():
    coeffs = jnp.asarray(C8)
    for x, v, d in UNCLAMPED_GOLDEN:
        val, der = eval_bspline(coeffs, jnp.asarray(x))
        np.testing.assert_allclose(float(val), v, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(der), d, rtol=1e-10, atol=1e-12)


def _qs_value_fn(x1, x2):
    p = jnp.asarray(QS_PARAMS)[None, None, :]
    mask = jnp.ones((1, 1), bool)
    return quadspline_coverage(p, x1[None, 0:3], x1[None, 3:6],
                               x2[None, 0:3], x2[None, 3:6],
                               QS_KA, QS_K, QS_INV_DX, mask)[0, 0]


def test_quadspline_value_vs_golden():
    for x1, x2, cov, _d1, _d2 in QS_GOLDEN:
        got = float(_qs_value_fn(jnp.asarray(x1), jnp.asarray(x2)))
        np.testing.assert_allclose(got, cov, rtol=1e-9)


def test_quadspline_gradient_vs_golden_partition():
    """jax.grad of the repo kernel must equal the reference's hand-written
    derivative partition (bead_interaction.h:61-81)."""
    g = jax.grad(_qs_value_fn, argnums=(0, 1))
    for x1, x2, _cov, d1, d2 in QS_GOLDEN:
        g1, g2 = g(jnp.asarray(x1, jnp.float64), jnp.asarray(x2, jnp.float64))
        np.testing.assert_allclose(np.asarray(g1), d1, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(np.asarray(g2), d2, rtol=1e-8, atol=1e-12)


def test_pair_coverage_vs_golden():
    """The pair-grid wrapper every pair node calls (ops/pairs.py
    pair_coverage: parameter gather, cutoff mask, dense-window splines)
    against the same C++ fixtures, in float32 as the device runs it."""
    from upside_md.ops.pairs import pair_coverage
    table = jnp.asarray(QS_PARAMS, jnp.float32)[None, None, :]
    t = np.zeros((1,), np.int32)
    mask = jnp.ones((1, 1), bool)
    for x1, x2, cov, _d1, _d2 in QS_GOLDEN:
        got = pair_coverage(table, t, t, jnp.asarray(x1, jnp.float32)[None],
                            jnp.asarray(x2, jnp.float32)[None], mask,
                            QS_KA, QS_K, 1.0 / QS_INV_DX)
        np.testing.assert_allclose(float(got[0, 0]), cov, rtol=2e-5)


def test_hbond_pair_strength_vs_golden():
    p = jnp.asarray(HB_PARAMS)[None, None, :]
    for x1, x2, hb, hbl in HB_GOLDEN:
        x1 = jnp.asarray(x1)
        x2 = jnp.asarray(x2)
        got = hbond_pair_strength(p, x1[None, 0:3], x1[None, 3:6],
                                  x2[None, 0:3], x2[None, 3:6])[0, 0]
        np.testing.assert_allclose(float(got), hb, rtol=1e-9, atol=1e-12)
        got_log = float(jnp.where(got >= 1.0, 100.0,
                                  -jnp.log(jnp.maximum(1.0 - got, 1e-5))))
        np.testing.assert_allclose(got_log, hbl, rtol=1e-9, atol=1e-12)


def test_bethe_free_energy_vs_golden():
    """bethe_free_energy on a 2-node/1-edge system built so its internal
    pair marginal equals the pinned literal: edge beliefs set equal to the
    node marginals make the belief-correction factors unity, so the kernel's
    pair marginal reduces to normalize(P) — the pinned marginal."""
    R = 2
    valid = np.zeros((R, 6), bool)
    valid[:, :3] = True
    b = np.zeros((R, 6))
    b[0, :3], b[1, :3] = BETHE_B[0], BETHE_B[1]
    pr = np.zeros((R, 6))
    pr[0, :3], pr[1, :3] = BETHE_PR[0], BETHE_PR[1]
    offset = np.asarray(BETHE_OFF)
    # E1 chosen so exp(offset - E1) reproduces the pinned node probs
    E1 = np.where(valid, offset[:, None] - np.log(np.maximum(pr, 1e-300)),
                  0.0)
    P = np.zeros((R, R, 6, 6))
    P[0, 1, :3, :3] = BETHE_P
    P[1, 0, :3, :3] = BETHE_P.T
    adj = np.zeros((R, R), bool)
    adj[0, 1] = adj[1, 0] = True
    eb = np.broadcast_to(b[:, None, :], (R, R, 6)).copy()

    total = bethe_free_energy(
        jnp.asarray(E1), jnp.asarray(offset), jnp.asarray(P),
        jnp.asarray(adj), jnp.asarray(valid), jnp.asarray(b),
        jnp.asarray(eb))
    expected = sum(BETHE_NODE_GOLDEN) + BETHE_EDGE_GOLDEN
    # kernel epsilons (EPS in belief-correction quotients) cost ~1e-9
    np.testing.assert_allclose(float(total), expected, rtol=1e-6)
    assert EPS == 1e-10  # the reference's stabilizer (rotamer.cpp:300,446)
