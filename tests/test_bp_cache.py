"""The rotamer node's BP solve on its one path: warm starts reach the cold
answer, the MD cache protocol (System.energy_and_cache) keeps a stable
structure and the stateless energy, and every solve reports its final
deviation and sweep count."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from upside_md.nodes.rotamer import (MAX_ROT, BPCache, _bp_solve,
                                     bethe_free_energy, bp_solve_health)
from upside_md.system import build_system

from test_rotamer import make_bead_system


def make_problem(rng, R=21, edge_density=0.15):
    E1 = 2.0 * rng.normal(size=(R, MAX_ROT))
    E2 = 0.4 * rng.normal(size=(R, R, MAX_ROT, MAX_ROT))
    E2 = E2 + np.transpose(E2, (1, 0, 3, 2))
    adj = np.triu(rng.random((R, R)) < edge_density, 1)
    adj = adj | adj.T
    valid = np.arange(MAX_ROT)[None, :] < rng.integers(1, 7, (R,))[:, None]
    E2 = E2 * adj[:, :, None, None]
    return (jnp.asarray(E1), jnp.asarray(E2), jnp.asarray(adj),
            jnp.asarray(valid))


def free_energy(E1, E2, adj, valid, init=None, tol=1e-4, max_iter=1000):
    off = jnp.min(jnp.where(valid, E1, jnp.inf), axis=-1)
    pr = jnp.where(valid, jnp.exp(off[:, None] - E1), 0.0)
    P = jnp.exp(-E2)
    nb, eb, dev, sweeps = _bp_solve(pr, P, adj, valid, 0.4, max_iter, tol,
                                    2, init=init)
    return bethe_free_energy(E1, off, P, adj, valid, nb, eb), nb, eb, \
        dev, sweeps


def test_xla_warm_start_reaches_same_answer(rng):
    E1, E2, adj, valid = make_problem(rng)
    _, nb, eb, _, _ = free_energy(E1, E2, adj, valid)
    # warm start from the converged messages on a slightly perturbed
    # problem, and from the uniform init_cache state
    E1b = E1 + 0.01 * jnp.asarray(rng.normal(size=E1.shape))
    F_cold = float(free_energy(E1b, E2, adj, valid)[0])
    F_warm, _, _, _, it_warm = free_energy(E1b, E2, adj, valid,
                                           init=(nb, eb))
    uniform = (jnp.asarray(valid, E1.dtype),
               jnp.ones(adj.shape + (MAX_ROT,), E1.dtype))
    F_unif = float(free_energy(E1b, E2, adj, valid, init=uniform)[0])
    assert abs(float(F_warm) - F_cold) < 5e-3
    assert abs(F_unif - F_cold) < 5e-3
    _, _, _, _, it_cold = free_energy(E1b, E2, adj, valid)
    assert int(it_warm) <= int(it_cold)


def test_xla_energy_and_cache_protocol(rng):
    """Warm-start messages thread through System.energy_and_cache without
    changing the energy, in a structure a fori_loop carry accepts."""
    specs, beads, e1, consts, table = make_bead_system(
        rng, [3, 6, 3, 6], spread=6.0)
    consts["tol"] = 1e-6
    sys = build_system(1, specs)
    params = sys.make_params()
    pos = jnp.zeros((1, 3))

    e_plain = float(sys.energy(pos, params))
    cache0 = sys.init_cache()
    assert isinstance(cache0["rotamer"], BPCache)
    e1_, cache1 = sys.energy_and_cache(pos, params, cache=cache0)
    e2_, cache2 = sys.energy_and_cache(pos, params, cache=cache1)
    assert abs(float(e1_) - e_plain) < 1e-4
    assert abs(float(e2_) - e_plain) < 1e-4
    assert jax.tree.structure(cache0) == jax.tree.structure(cache1) == \
        jax.tree.structure(cache2)
    for a, b in zip(jax.tree.leaves(cache1), jax.tree.leaves(cache2)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # a converged warm start needs no more sweeps than the uniform start
    assert int(cache2["rotamer"].sweeps) <= int(cache1["rotamer"].sweeps)


def test_xla_md_with_cache_matches_plain_energy(rng):
    """A short MD advance threads the cache; the cache-threaded energy
    equals the stateless energy and the solve health rides along."""
    from upside_md.md.sim import Simulation
    specs, beads, e1, consts, table = make_bead_system(
        rng, [3, 3, 6], spread=6.0)
    consts["tol"] = 1e-6
    sys = build_system(4, specs)
    params = sys.make_params()
    sim = Simulation(sys, dt=0.005, do_recenter=False)
    state = sim.initial_state(jnp.zeros((4, 3)), params, seed=0,
                              temperature=0.5)
    state2 = sim.advance(state, params, 3)
    assert int(state2.round_num) == 3
    e_cached, _ = sys.energy_and_cache(state2.pos, params,
                                       cache=state2.cache)
    e_plain = sys.energy(state2.pos, params)
    assert np.isfinite(float(e_plain))
    assert abs(float(e_cached) - float(e_plain)) < 1e-4
    dev, sweeps = bp_solve_health(state2.cache["rotamer"])
    assert float(dev) <= 1e-6 and 2 <= int(sweeps) < 2000


@pytest.mark.parametrize("max_iter", [1000, 4])
def test_bp_solve_reports_deviation_and_sweeps(rng, max_iter):
    """A converged solve reports deviation <= tol before max_iter; a solve
    cut at max_iter reports deviation > tol: the n_bad_solve signal."""
    E1, E2, adj, valid = make_problem(rng, R=15, edge_density=0.4)
    E2 = 3.0 * E2                     # frustrated enough to need sweeps
    _, _, _, dev, sweeps = free_energy(E1, E2, adj, valid, tol=1e-6,
                                       max_iter=max_iter)
    if max_iter == 4:
        assert int(sweeps) == 4 and float(dev) > 1e-6
    else:
        assert 4 < int(sweeps) < max_iter and float(dev) <= 1e-6
