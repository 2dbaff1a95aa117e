"""Extrapolated BP warm starts (UPSIDE_BP_EXTRAP): same answers, fewer
sweeps, history and solve health threading through the cache protocol."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from upside_md import build_system
from upside_md.nodes.rotamer import MAX_ROT, _extrapolate_beliefs

from test_rotamer import make_bead_system


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_extrapolate_kernel_layout():
    """Solver belief layout: nb (R, 6) max-normalized, eb (R, R, 6)
    normalized across the rotamer-slot axis."""
    rng = np.random.default_rng(0)
    R = 12
    nb0 = np.zeros((R, MAX_ROT), np.float32)
    nb0[:10] = rng.uniform(0.2, 1.0, (10, MAX_ROT))
    nb1 = nb0 * rng.uniform(0.9, 1.1, (R, MAX_ROT)).astype(np.float32)
    nb0 /= np.maximum(nb0.max(-1, keepdims=True), 1e-10)
    nb1 /= np.maximum(nb1.max(-1, keepdims=True), 1e-10)

    eb0 = np.ones((R, R, MAX_ROT), np.float32)
    eb1 = np.ones((R, R, MAX_ROT), np.float32)
    # one moved message, everything else pinned at 1.0 (non-edges)
    eb0[3, 4] = rng.uniform(0.1, 0.5, MAX_ROT)
    eb1[3, 4] = eb0[3, 4] * rng.uniform(0.8, 1.2, MAX_ROT)
    eb0[3, 4] /= eb0[3, 4].sum()
    eb1[3, 4] /= eb1[3, 4].sum()

    nbx, ebx = jax.tree.map(
        np.asarray,
        _extrapolate_beliefs((jnp.asarray(nb1), jnp.asarray(eb1)),
                             (jnp.asarray(nb0), jnp.asarray(eb0)), 1.0))

    assert nbx.shape == (R, MAX_ROT) and ebx.shape == (R, R, MAX_ROT)
    # zero rows (invalid residues) stay exactly zero
    np.testing.assert_array_equal(nbx[10:], 0.0)
    # belief rows stay max-normalized
    assert np.allclose(nbx[:10].max(-1), 1.0, atol=1e-6)
    # unmoved messages (non-edges) keep their exact stored value
    mask = np.ones((R, R), bool)
    mask[3, 4] = False
    np.testing.assert_array_equal(ebx[mask], eb1[mask])
    # the moved message extrapolates in log space and is renormalized
    assert not np.allclose(ebx[3, 4], eb1[3, 4])
    assert np.isclose(ebx[3, 4].sum(), 1.0, atol=1e-5)
    expect = eb1[3, 4] * np.clip(eb1[3, 4] / eb0[3, 4], 0.1, 10.0)
    expect /= expect.sum()
    np.testing.assert_allclose(ebx[3, 4], expect, rtol=1e-5)


def test_extrap_same_energy_fewer_sweeps(rng, monkeypatch):
    """Along drifting bead positions the extrapolated warm start matches
    the plain warm start's energies to solver tolerance and does not
    need more sweeps."""
    specs, beads, e1, consts, table = make_bead_system(
        rng, [2, 3, 2, 4, 3], spread=6.0)
    # realistic solver tolerance: the fixture's 1e-10 saturates max_iter
    # in f32, which would make sweep counts meaningless
    consts["tol"] = 1e-5
    system = build_system(1, specs)
    params = system.make_params()

    drift = 0.02 * rng.normal(size=beads.shape)

    def run(extrap):
        # "off" (not unset): plain warm start is no longer the default
        monkeypatch.setenv("UPSIDE_BP_EXTRAP", "1.0" if extrap else "off")
        cache = system.init_cache()
        energies, iters = [], []
        for i in range(6):
            p = dict(params)
            p["constant"] = {"value": jnp.asarray(beads + i * drift)}
            e, cache = system.energy_and_cache(
                jnp.zeros((1, 3)), p, cache=cache)
            energies.append(float(e))
            iters.append(int(cache["rotamer"].sweeps))
        return np.asarray(energies), iters, cache

    e_warm, it_warm, _ = run(False)
    e_ex, it_ex, cache_ex = run(True)

    # both-array history threads through the cache
    assert cache_ex["rotamer"].prev_node_belief is not None
    assert cache_ex["rotamer"].prev_edge_belief is not None
    np.testing.assert_allclose(e_ex, e_warm, rtol=1e-5, atol=1e-5)
    assert sum(it_ex) <= sum(it_warm)


def test_extrap_nb_only_mode(rng, monkeypatch):
    """UPSIDE_BP_EXTRAP=nb:<a> keeps only node-belief history and matches
    the plain warm start's answers."""
    specs, beads, e1, consts, table = make_bead_system(
        rng, [2, 3, 2, 4, 3], spread=6.0)
    consts["tol"] = 1e-5   # see test_extrap_same_energy_fewer_sweeps
    system = build_system(1, specs)
    params = system.make_params()
    drift = 0.02 * rng.normal(size=beads.shape)

    def run(env):
        monkeypatch.setenv("UPSIDE_BP_EXTRAP", env or "off")
        cache = system.init_cache()
        energies = []
        for i in range(5):
            p = dict(params)
            p["constant"] = {"value": jnp.asarray(beads + i * drift)}
            e, cache = system.energy_and_cache(
                jnp.zeros((1, 3)), p, cache=cache)
            energies.append(float(e))
        return np.asarray(energies), cache

    e_warm, _ = run(None)
    e_nb, cache_nb = run("nb:1.0")
    assert cache_nb["rotamer"].prev_node_belief is not None
    assert cache_nb["rotamer"].prev_edge_belief is None
    np.testing.assert_allclose(e_nb, e_warm, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("extrap", ["off", "nb:1.0", "1.0"])
def test_bp_solve_health_any_history_length(rng, monkeypatch, extrap):
    """The health reader takes a rotamer cache entry in every history
    mode (plain warm start, nb-only, both arrays), batched over
    replicas, and returns None for anything else."""
    from upside_md.nodes.rotamer import bp_solve_health
    monkeypatch.setenv("UPSIDE_BP_EXTRAP", extrap)
    specs, beads, e1, consts, table = make_bead_system(
        rng, [2, 3, 2, 4], spread=6.0)
    consts["tol"] = 1e-5
    system = build_system(1, specs)
    params = system.make_params()
    cache = system.init_cache()
    _, cache = system.energy_and_cache(jnp.zeros((1, 3)), params,
                                       cache=cache)
    dev, sweeps = bp_solve_health(cache["rotamer"])
    assert 0 < float(dev) <= 1e-5
    assert 2 <= int(sweeps) < int(consts["max_iter"])
    batched = jax.tree.map(lambda x: jnp.stack([x, x, x]),
                           cache["rotamer"])
    dev, sweeps = bp_solve_health(batched)
    assert dev.shape == (3,) and sweeps.shape == (3,)
    assert bp_solve_health((np.zeros((5, 6)), np.ones((5, 5, 6)))) is None
    assert bp_solve_health(None) is None


def test_damping_override_same_fixed_point(rng, monkeypatch):
    """UPSIDE_BP_DAMPING only reshapes the convergence path: energies
    match the config-damping solve to solver tolerance."""
    specs, beads, e1, consts, table = make_bead_system(
        rng, [3, 2, 4, 2, 3], spread=6.0)
    # production-like solver settings (the fixture defaults to damping 0)
    consts["damping"] = 0.4
    consts["tol"] = 1e-6
    system = build_system(1, specs)
    params = system.make_params()

    def one(env):
        if env:
            monkeypatch.setenv("UPSIDE_BP_DAMPING", env)
        else:
            monkeypatch.delenv("UPSIDE_BP_DAMPING", raising=False)
        cache = system.init_cache()
        e, cache = system.energy_and_cache(jnp.zeros((1, 3)), params,
                                           cache=cache)
        return float(e), int(cache["rotamer"].sweeps)

    e_cfg, it_cfg = one(None)
    e_low, it_low = one("0.1")
    assert np.isclose(e_low, e_cfg, rtol=1e-4, atol=1e-4)
    assert it_low <= it_cfg
