"""Fixed-K neighbor-list pair kernels match the masked-dense computation."""

import numpy as np
import jax
import jax.numpy as jnp

import upside_md.nodes.rotamer as rot
from upside_md.ops.pairs import (neighbor_list, quadspline_coverage,
                                     quadspline_coverage_nl,
                                     gather_pair_params, scatter_rows,
                                     sequence_exclusion_mask)


def make_beads(rng, n, n_type=3):
    pos = 4.0 * rng.normal(size=(n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.integers(0, n_type, n).astype(np.int32)
    ka, k = 8, 9
    table = rng.normal(size=(n_type, n_type, 2 * ka + 2 * k))
    return (jnp.asarray(pos), jnp.asarray(d), jnp.asarray(t),
            jnp.asarray(table), ka, k)


def test_neighbor_list_exact(rng):
    pos1, d1, t1, table, ka, k = make_beads(rng, 64)
    pos2, d2, t2, _, _, _ = make_beads(rng, 80)
    base = sequence_exclusion_mask(
        jnp.asarray(np.arange(64, dtype=np.int32)),
        jnp.asarray(np.arange(80, dtype=np.int32)), 2)
    inv_dx = 1.0

    p = gather_pair_params(table, t1, t2)
    disp = pos2[None] - pos1[:, None]
    dist2 = jnp.sum(disp * disp, -1)
    cutoff = (k - 2 - 1e-6) / inv_dx
    mask = base & (dist2 < cutoff * cutoff)
    dense = quadspline_coverage(p, pos1, d1, pos2, d2, ka, k, inv_dx, mask)

    cov, idx, nmask = quadspline_coverage_nl(
        table, t1, t2, pos1, d1, pos2, d2, ka, k, inv_dx, base, K=80)
    back = scatter_rows(cov, idx, nmask, 80)
    np.testing.assert_allclose(np.asarray(back), np.asarray(dense),
                               atol=1e-10)


def test_neighbor_list_grad_matches(rng):
    pos1, d1, t1, table, ka, k = make_beads(rng, 48)
    base = jnp.asarray(np.triu(np.ones((48, 48), bool), 1))

    def dense_sum(p1):
        p = gather_pair_params(table, t1, t1)
        disp = p1[None] - p1[:, None]
        dist2 = jnp.sum(disp * disp, -1)
        mask = base & (dist2 < 7.0 ** 2)
        return jnp.sum(quadspline_coverage(p, p1, d1, p1, d1, ka, k, 1.0,
                                           mask))

    def nl_sum(p1):
        cov, idx, nmask = quadspline_coverage_nl(
            table, t1, t1, p1, d1, p1, d1, ka, k, 1.0, base, K=48)
        return jnp.sum(cov)

    assert abs(float(dense_sum(pos1)) - float(nl_sum(pos1))) < 1e-8
    g1 = np.asarray(jax.grad(dense_sum)(pos1))
    g2 = np.asarray(jax.grad(nl_sum)(pos1))
    np.testing.assert_allclose(g2, g1, atol=1e-8)


def test_rotamer_nl_matches_dense(rng, monkeypatch):
    # build a bead system big enough to trigger the NL path and compare
    # against the dense path by flipping the threshold
    import sys
    sys.path.insert(0, 'tests')
    from test_rotamer import make_bead_system
    n_rot = [3, 6, 3, 1, 6, 3, 3, 6, 1, 3] * 5   # 50 residues, ~180 beads
    specs, beads, e1, consts, table = make_bead_system(rng, n_rot, spread=2.0)
    from upside_md import build_system
    sys_ = build_system(1, specs)
    params = sys_.make_params()

    monkeypatch.setattr(rot, 'NEIGHBOR_LIST_THRESHOLD', 10 ** 9)
    e_dense = float(sys_.energy(jnp.zeros((1, 3)), params))
    monkeypatch.setattr(rot, 'NEIGHBOR_LIST_THRESHOLD', 1)
    monkeypatch.setattr(rot, 'NEIGHBOR_K', 256)
    # under jit: numpy consts indexed by traced neighbor ids must work
    e_nl = float(jax.jit(sys_.energy)(jnp.zeros((1, 3)), params))
    assert abs(e_dense - e_nl) < 1e-6, (e_dense, e_nl)
