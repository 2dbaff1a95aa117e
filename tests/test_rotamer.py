"""Rotamer BP solver: exactness on trees, envelope gradient on loopy graphs.

On a tree factor graph, loopy BP converges to exact marginals and the Bethe
free energy equals -log Z, so the node's potential can be checked against
brute-force enumeration over rotamer states.
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp

from upside_md import build_system
from upside_md.nodes.rotamer import (
    MAX_ROT, assemble_rotamer_energies, make_rotamer_consts,
    rotamer_marginals)

from helpers import spec


def pack_id(res, n_rot, rot):
    return (res << 8) | (n_rot << 4) | rot


def make_bead_system(rng, n_rot_per_res, spread=3.0, n_param=2 * 8 + 2 * 9):
    """Bead cloud with one bead per (residue, rotamer) plus a smooth
    directional spline table."""
    beads = []
    ids = []
    for r, n_rot in enumerate(n_rot_per_res):
        base = np.array([spread * r, 0.0, 0.0])
        for o in range(n_rot):
            p = base + 0.8 * rng.normal(size=3)
            d = rng.normal(size=3)
            d /= np.linalg.norm(d)
            beads.append(np.concatenate([p, d]))
            ids.append(pack_id(r, n_rot, o))
    beads = np.array(beads)
    n_bead = len(beads)

    # smooth random spline tables; angular splines near 1, distance
    # splines clamped to zero at the right end (reference convention)
    ka, k = 8, 9
    table = np.zeros((1, 1, n_param))
    table[..., :2 * ka] = 1.0 + 0.3 * rng.normal(size=2 * ka)
    dist_part = 0.5 * rng.normal(size=2 * k)
    dist_part[k - 3:k] = 0.0
    dist_part[2 * k - 3:] = 0.0
    table[..., 2 * ka:] = dist_part

    consts = make_rotamer_consts(np.array(ids), np.arange(n_bead),
                                 np.zeros(n_bead, np.int32),
                                 damping=0.0, max_iter=2000, tol=1e-10)
    e1 = rng.normal(size=(n_bead, 1))

    specs = [
        spec("constant", [], {}, {"value": beads}),
        spec("constant_e1", [], {}, {"value": e1}),
        spec("rotamer", ["constant", "constant_e1"], consts,
             {"interaction_param": table}),
    ]
    return specs, beads, e1, consts, table


def brute_force_free_energy(consts, params, inputs):
    """-log Z by enumeration using the node's own assembled energies."""
    E1, offset, prob, E2, adj, valid = [
        np.asarray(v) for v in assemble_rotamer_energies(
            consts, {"interaction_param": jnp.asarray(params)}, inputs)]
    n_rot = np.asarray(consts["n_rot_per_res"])
    R = len(n_rot)
    states = itertools.product(*[range(n) for n in n_rot])
    zs = []
    for s in states:
        e = sum(E1[r, s[r]] for r in range(R))
        for i in range(R):
            for j in range(i + 1, R):
                if adj[i, j]:
                    e += E2[i, j, s[i], s[j]]
        zs.append(-e)
    zs = np.array(zs)
    m = zs.max()
    return -(m + np.log(np.exp(zs - m).sum()))


def _assert_chain_adjacency(consts, table, inputs):
    _, _, _, _, adj, _ = assemble_rotamer_energies(
        consts, {"interaction_param": jnp.asarray(table)}, inputs)
    adj = np.asarray(adj)
    R = adj.shape[0]
    expect = np.zeros_like(adj)
    for i in range(R - 1):
        expect[i, i + 1] = expect[i + 1, i] = True
    assert (adj == expect).all(), adj.astype(int)


def test_bp_exact_on_chain(rng):
    # residues far enough apart that only neighbors interact -> tree
    specs, beads, e1, consts, table = make_bead_system(
        rng, [3, 6, 3, 1, 6], spread=6.0)
    inputs = [jnp.asarray(beads), jnp.asarray(e1)]
    _assert_chain_adjacency(consts, table, inputs)
    sys = build_system(1, specs)
    params = sys.make_params()
    pot = float(sys.energy(jnp.zeros((1, 3)), params))

    exact = brute_force_free_energy(consts, table, inputs)
    assert abs(pot - exact) < 1e-4, (pot, exact)


def test_bp_marginals_exact_on_chain(rng):
    specs, beads, e1, consts, table = make_bead_system(
        rng, [3, 3, 6], spread=6.0)
    inputs = [jnp.asarray(beads), jnp.asarray(e1)]
    _assert_chain_adjacency(consts, table, inputs)
    nb, bead_marg = rotamer_marginals(
        consts, {"interaction_param": jnp.asarray(table)}, inputs)
    nb = np.asarray(nb)

    # brute-force marginals
    E1, offset, prob, E2, adj, valid = [
        np.asarray(v) for v in assemble_rotamer_energies(
            consts, {"interaction_param": jnp.asarray(table)}, inputs)]
    n_rot = np.asarray(consts["n_rot_per_res"])
    R = len(n_rot)
    marg = np.zeros((R, MAX_ROT))
    Z = 0.0
    for s in itertools.product(*[range(n) for n in n_rot]):
        e = sum(E1[r, s[r]] for r in range(R))
        for i in range(R):
            for j in range(i + 1, R):
                if adj[i, j]:
                    e += E2[i, j, s[i], s[j]]
        w = np.exp(-(e - E1.min()))
        Z += w
        for r in range(R):
            marg[r, s[r]] += w
    marg /= Z
    np.testing.assert_allclose(nb, marg, atol=1e-5)


def test_bp_loopy_envelope_gradient(rng):
    # compact cluster -> loopy graph; check that autodiff (marginals
    # stop-gradded) matches finite differences of the full solve, which is
    # the envelope-theorem statement at the Bethe stationary point
    specs, beads, e1, consts, table = make_bead_system(
        rng, [3, 3, 3, 6], spread=1.2)
    sys = build_system(1, specs)
    params = sys.make_params()

    def f(bead_arr):
        p = dict(params)
        p["constant"] = {"value": bead_arr}
        return sys.energy(jnp.zeros((1, 3)), p)

    b0 = jnp.asarray(beads)
    g = np.asarray(jax.grad(f)(b0))

    eps = 1e-5
    for (i, d) in [(0, 0), (3, 1), (7, 2), (10, 4)]:
        bp_ = np.array(beads); bp_[i, d] += eps
        bm_ = np.array(beads); bm_[i, d] -= eps
        fd = (float(f(jnp.asarray(bp_))) - float(f(jnp.asarray(bm_)))) / (2 * eps)
        assert abs(fd - g[i, d]) < 5e-4, (i, d, fd, g[i, d])


def test_bp_1rot_residues_fold_correctly(rng):
    # a system of only 1-rotamer residues: free energy = sum of E1 + pair E
    specs, beads, e1, consts, table = make_bead_system(
        rng, [1, 1, 1], spread=2.0)
    sys = build_system(1, specs)
    pot = float(sys.energy(jnp.zeros((1, 3)), sys.make_params()))
    inputs = [jnp.asarray(beads), jnp.asarray(e1)]
    exact = brute_force_free_energy(consts, table, inputs)
    assert abs(pot - exact) < 1e-5
