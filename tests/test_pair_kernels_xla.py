"""The dense pair-spline path (ops/pairs.py) that every pair node runs:
values and gradients against the transcription of the reference kernel
(bead_interaction.h:30-84) for each shipped knot family, and finite
forces when masked or cut-off pairs carry poisoned cotangents or
coincident positions."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from upside_md.ops.pairs import pair_coverage, quadspline_family

from test_reference_goldens import _ref_quadspline

# (ka, k, dx) of the shipped families: SC_SC, SC_BB, 10 A
FAMILIES = [(8, 9, 1.0), (8, 7, 1.0), (8, 12, 1.0)]


def _table(rng, n1, n2, ka, k):
    t = np.zeros((n1, n2, 2 * ka + 2 * k))
    t[..., :2 * ka] = 1.0 + 0.3 * rng.normal(size=(n1, n2, 2 * ka))
    t[..., 2 * ka:] = 0.5 * rng.normal(size=(n1, n2, 2 * k))
    t[..., 2 * ka + k - 3:2 * ka + k] = 0.0
    t[..., 2 * ka + 2 * k - 3:] = 0.0
    return t


def _sites(rng, n, box):
    pos = box * rng.random((n, 3))
    d = rng.normal(size=(n, 3))
    return np.concatenate([pos, d / np.linalg.norm(d, axis=-1,
                                                   keepdims=True)], -1)


@pytest.mark.parametrize("family", FAMILIES, ids=["SC_SC", "SC_BB", "10A"])
def test_pair_coverage_value_and_gradient_per_family(rng, family):
    ka, k, dx = family
    assert quadspline_family(2 * ka + 2 * k) == family
    n1, n2 = 5, 7
    table = _table(rng, 2, 3, ka, k)
    t1 = rng.integers(0, 2, n1)
    t2 = rng.integers(0, 3, n2)
    f1 = _sites(rng, n1, 2.0 * k * dx / 3)
    f2 = _sites(rng, n2, 2.0 * k * dx / 3)
    base = np.ones((n1, n2), bool)
    base[0, 1] = False

    def total(a, b):
        return jnp.sum(pair_coverage(jnp.asarray(table), t1, t2, a, b,
                                     jnp.asarray(base), ka, k, dx))

    grid = np.asarray(pair_coverage(jnp.asarray(table), t1, t2,
                                    jnp.asarray(f1), jnp.asarray(f2),
                                    jnp.asarray(base), ka, k, dx))
    g1, g2 = jax.grad(total, argnums=(0, 1))(jnp.asarray(f1),
                                              jnp.asarray(f2))
    cutoff = (k - 2 - 1e-6) * dx
    ref = np.zeros((n1, n2))
    r1 = np.zeros_like(f1)
    r2 = np.zeros_like(f2)
    n_live = 0
    for i in range(n1):
        for j in range(n2):
            dist = np.linalg.norm(f2[j, :3] - f1[i, :3])
            if not base[i, j] or dist >= cutoff:
                continue
            n_live += 1
            c, d1, d2 = _ref_quadspline(ka, k, 1.0 / dx,
                                        table[t1[i], t2[j]], f1[i], f2[j])
            ref[i, j] = c
            r1[i] += d1
            r2[j] += d2
    assert n_live >= n1 * n2 // 3     # the check sees real pairs
    np.testing.assert_allclose(grid, ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(g1), r1, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(np.asarray(g2), r2, rtol=1e-7, atol=1e-10)

    # finite differences of the summed coverage in the positions
    eps = 1e-6
    for i, c in [(0, 0), (2, 1), (4, 2)]:
        fp, fm = f1.copy(), f1.copy()
        fp[i, c] += eps
        fm[i, c] -= eps
        fd = (float(total(jnp.asarray(fp), jnp.asarray(f2)))
              - float(total(jnp.asarray(fm), jnp.asarray(f2)))) / (2 * eps)
        np.testing.assert_allclose(float(g1[i, c]), fd, rtol=1e-5,
                                   atol=1e-7)


def _rotamer_grid(consts, params, feats):
    from upside_md.nodes.rotamer import assemble_pair_grid
    return assemble_pair_grid(consts, params, feats)[0]


def _coverage_grid(consts, params, feats):
    from upside_md.ops.pairs import sequence_exclusion_mask
    table = params["interaction_param"]
    ka, k, dx = quadspline_family(table.shape[-1])
    mask = sequence_exclusion_mask(consts["res"], consts["res"], 0)
    return pair_coverage(table, consts["type"], consts["type"], feats,
                         feats, mask, ka, k, dx)


def _environment(consts, params, feats):
    from upside_md.nodes.env import _environment_coverage
    sc = jnp.concatenate([feats[:, :3], jnp.ones((feats.shape[0], 1),
                                                 feats.dtype)], -1)
    return _environment_coverage(consts, params, [feats, sc], {})


@pytest.mark.parametrize("node", ["rotamer", "hbond_coverage",
                                  "environment_coverage"])
def test_dead_pairs_do_not_poison_forces(rng, node):
    """Pairs that are masked (same residue) or beyond the cutoff add
    nothing to the forces, even when two masked sites coincide exactly
    (dist = 0) and the caller's cotangent on dead grid slots is NaN or
    Inf (the grid is an intermediate that other code may differentiate
    through a loss with infinite slope at zero)."""
    from upside_md.nodes.rotamer import make_rotamer_consts
    n = 12
    res = np.repeat(np.arange(6), 2)          # two sites per residue
    feats = _sites(rng, n, 9.0)
    feats[1, :3] = feats[0, :3]               # coincident, same residue
    feats[11, :3] = feats[10, :3] + [30.0, 0.0, 0.0]   # far beyond cutoff
    ids = (((res << 4) + 6) << 4) + np.tile([0, 1], 6)
    consts = make_rotamer_consts(ids, np.arange(n), np.zeros(n, np.int32),
                                 damping=0.1, max_iter=100, tol=1e-3)
    ka, k = 8, 9
    params = {"interaction_param": jnp.asarray(_table(rng, 1, 1, ka, k))}
    if node == "environment_coverage":
        env_consts = {"index1": np.arange(n), "index2": np.arange(n),
                      "type1": np.zeros(n, np.int32),
                      "type2": np.zeros(n, np.int32),
                      "id1": res, "id2": res}
        env_params = {"interaction_param": jnp.asarray(
            [[[6.5, 0.5, 0.0, 2.0]]])}
        f = lambda x: jnp.sum(_environment(env_consts, env_params, x))  # noqa: E731
        g = np.asarray(jax.grad(f)(jnp.asarray(feats)))
        assert np.isfinite(g).all()
        return

    fn = _rotamer_grid if node == "rotamer" else _coverage_grid
    x = jnp.asarray(feats)
    grid, vjp = jax.vjp(lambda y: fn(consts, params, y), x)
    grid = np.asarray(grid)
    dead = grid == 0.0
    assert dead.sum() > n            # masked and cut-off slots exist
    clean = np.ones_like(grid)
    poisoned = clean.copy()
    poisoned[dead] = np.nan
    poisoned[0, 1] = np.inf if dead[0, 1] else poisoned[0, 1]
    g_clean = np.asarray(vjp(jnp.asarray(np.where(dead, 0.0, clean)))[0])
    g_poison = np.asarray(vjp(jnp.asarray(poisoned))[0])
    assert np.isfinite(g_poison).all()
    np.testing.assert_allclose(g_poison, g_clean, rtol=1e-12, atol=1e-12)
