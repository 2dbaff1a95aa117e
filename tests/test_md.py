"""MD machinery: integrator symplecticity, thermostat equipartition,
Monte Carlo moves, replica exchange."""

import numpy as np
import jax
import jax.numpy as jnp

from upside_md import build_system
from upside_md.md.mc import JumpSampler, PivotSampler, metropolis_step
from upside_md.md.replica import (ReplicaExchange, even_odd_swap_sets,
                                      parse_swap_sets)
from upside_md.md.sim import Simulation
from upside_md.ops.geometry import dihedral

from helpers import chain_positions, spec


def harmonic_system(n_atom, k=3.0):
    s = spec("atom_pos_spring", ["pos"],
             {"id": np.arange(n_atom, dtype=np.int32)},
             {"x0": np.zeros((n_atom, 3)),
              "spring_const": np.full(n_atom, k)})
    return build_system(n_atom, [s])


def test_verlet_energy_conservation(rng):
    n_atom = 8
    sys = harmonic_system(n_atom)
    sim = Simulation(sys, dt=0.005, thermostat_interval=1e10,
                     do_recenter=False)
    pos0 = 0.5 * rng.normal(size=(n_atom, 3))
    params = sys.make_params()
    state = sim.initial_state(pos0, params, seed=1, temperature=1.0)
    # the thermostat fires once at round 0 (reference does the same), so
    # measure the conserved energy after the first round
    state = sim.advance(state, params, 1)
    e0 = float(sim.potential_energy(state, params)) + \
        0.5 * float(jnp.sum(state.mom ** 2))
    state = sim.advance(state, params, 400)
    e1 = float(sim.potential_energy(state, params)) + \
        0.5 * float(jnp.sum(state.mom ** 2))
    assert abs(e1 - e0) / abs(e0) < 2e-3, (e0, e1)


def test_thermostat_equipartition(rng):
    # harmonic well at T=1.3: <KE>/1.5T should be ~1 (main.cpp:684-695)
    n_atom = 64
    T = 1.3
    sys = harmonic_system(n_atom)
    sim = Simulation(sys, dt=0.01, thermostat_interval=0.09,
                     do_recenter=False)
    params = sys.make_params()
    state = sim.initial_state(0.3 * rng.normal(size=(n_atom, 3)), params,
                              seed=3, temperature=T)
    kes = []
    for _ in range(60):
        state = sim.advance(state, params, 30)
        kes.append(float(sim.kinetic_energy(state)))
    ratio = np.mean(kes[20:]) / (1.5 * T)
    assert abs(ratio - 1.0) < 0.1, ratio


def test_batched_replicas_advance(rng):
    n_atom = 6
    sys = harmonic_system(n_atom)
    sim = Simulation(sys, dt=0.01, thermostat_interval=0.09,
                     do_recenter=False)
    params = sys.make_params()
    state = sim.initial_state(0.2 * rng.normal(size=(n_atom, 3)), params,
                              seed=5, temperature=[0.5, 1.0, 1.5, 2.0],
                              n_replica=4)
    state = sim.advance(state, params, 50, True)
    assert state.pos.shape == (4, n_atom, 3)
    assert np.all(np.asarray(state.round_num) == 50)
    # different seeds => different trajectories
    assert not np.allclose(np.asarray(state.pos[0]),
                           np.asarray(state.pos[1]))


def test_pivot_move_sets_target_rama(rng):
    n_res = 4
    pos = jnp.asarray(chain_positions(n_res, rng))
    # pivot at residue 1: prevC, N, CA, C, nextN; rotate residues 2..4
    atoms = np.array([[2, 3, 4, 5, 6]], np.int32)
    piv_range = np.array([[7, 12]], np.int32)
    sampler = PivotSampler.from_tables(
        atoms, piv_range, np.zeros(1, np.int32), np.zeros((1, 6, 6)))
    key = jax.random.PRNGKey(0)
    new_pos, dlp = sampler.propose(key, pos)
    assert abs(float(dlp)) < 1e-6  # uniform proposal
    # the new phi/psi at the pivot equal a bin center + offset; verify the
    # move actually changed the pivot dihedrals and left upstream atoms
    np.testing.assert_allclose(np.asarray(new_pos[:5]), np.asarray(pos[:5]))
    phi_old = float(dihedral(pos[2], pos[3], pos[4], pos[5]))
    phi_new = float(dihedral(new_pos[2], new_pos[3], new_pos[4], new_pos[5]))
    assert abs(phi_new - phi_old) > 1e-3


def test_pivot_metropolis_accepts_uniform(rng):
    n_res = 4
    pos = jnp.asarray(chain_positions(n_res, rng))
    atoms = np.array([[2, 3, 4, 5, 6]], np.int32)
    piv_range = np.array([[7, 12]], np.int32)
    sampler = PivotSampler.from_tables(
        atoms, piv_range, np.zeros(1, np.int32), np.zeros((1, 6, 6)))
    new_pos, acc = metropolis_step(jax.random.PRNGKey(1), pos, 1.0,
                                   lambda p: jnp.asarray(0.0), sampler)
    assert bool(acc)


def test_jump_move_rigid(rng):
    pos = jnp.asarray(chain_positions(3, rng))
    sampler = JumpSampler(np.array([[0, 4], [4, 9]], np.int32),
                          np.array([0.5, 0.5]), np.array([0.3, 0.3]))
    new_pos, dlp = sampler.propose(jax.random.PRNGKey(2), pos)
    assert float(dlp) == 0.0
    moved = ~np.all(np.isclose(np.asarray(new_pos), np.asarray(pos)), -1)
    # exactly one chain moved, rigidly (pairwise distances preserved)
    idx = np.where(moved)[0]
    assert len(idx) in (4, 5)
    d_old = np.linalg.norm(np.asarray(pos)[idx][:, None] -
                           np.asarray(pos)[idx][None], axis=-1)
    d_new = np.linalg.norm(np.asarray(new_pos)[idx][:, None] -
                           np.asarray(new_pos)[idx][None], axis=-1)
    np.testing.assert_allclose(d_new, d_old, atol=1e-8)


def test_replica_exchange_equal_temperature_always_swaps(rng):
    n_rep, n_atom = 4, 5
    sys = harmonic_system(n_atom)
    params = sys.make_params()
    pos = jnp.asarray(rng.normal(size=(n_rep, n_atom, 3)))
    beta = jnp.ones(n_rep)
    rex = ReplicaExchange(even_odd_swap_sets(n_rep), n_rep)
    energy_of = jax.vmap(lambda p: sys.energy(p, params))
    new_pos, idx, stats, _ = rex.attempt_swaps(
        jax.random.PRNGKey(0), pos, jnp.arange(n_rep), beta, energy_of)
    # equal temperatures: Delta=0 => all swaps accepted
    for s in stats:
        assert (np.asarray(s)[:, 0] == np.asarray(s)[:, 1]).all()
    # composition of the two swap sets on indices
    assert sorted(np.asarray(idx).tolist()) == list(range(n_rep))


def test_replica_exchange_preserves_configurations(rng):
    n_rep, n_atom = 4, 5
    sys = harmonic_system(n_atom)
    params = sys.make_params()
    pos = jnp.asarray(rng.normal(size=(n_rep, n_atom, 3)))
    beta = jnp.asarray([2.0, 1.5, 1.0, 0.5])
    rex = ReplicaExchange(parse_swap_sets(["0-1,2-3", "1-2"], n_rep), n_rep)
    energy_of = jax.vmap(lambda p: sys.energy(p, params))
    new_pos, idx, _, _ = rex.attempt_swaps(
        jax.random.PRNGKey(3), pos, jnp.arange(n_rep), beta, energy_of,
        slot_independent=True)
    # configurations are permuted, never altered
    old = {tuple(np.round(np.asarray(p).ravel(), 6)) for p in pos}
    new = {tuple(np.round(np.asarray(p).ravel(), 6)) for p in new_pos}
    assert old == new


def test_replica_exchange_energy_carry_paths_agree(rng):
    """Carrying energies through swap sets (and permuting them for pure
    temperature exchange) is exact: all three evaluation modes produce the
    same swaps, indices, and final energies."""
    n_rep, n_atom = 6, 5
    sys = harmonic_system(n_atom)
    params = sys.make_params()
    pos = jnp.asarray(rng.normal(size=(n_rep, n_atom, 3)))
    beta = jnp.asarray(1.0 / (0.8 + 0.1 * np.arange(n_rep)))
    rex = ReplicaExchange(even_odd_swap_sets(n_rep), n_rep)
    energy_of = jax.vmap(lambda p: sys.energy(p, params))
    key = jax.random.PRNGKey(11)
    idx0 = jnp.arange(n_rep)

    outs = [
        rex.attempt_swaps(key, pos, idx0, beta, energy_of),
        rex.attempt_swaps(key, pos, idx0, beta, energy_of,
                          slot_independent=True),
        rex.attempt_swaps(key, pos, idx0, beta, energy_of,
                          energies=energy_of(pos), slot_independent=True),
    ]
    ref_pos, ref_idx, ref_stats, ref_en = outs[0]
    np.testing.assert_allclose(np.asarray(ref_en),
                               np.asarray(energy_of(ref_pos)), rtol=1e-12)
    for new_pos, idx, stats, en in outs[1:]:
        np.testing.assert_allclose(np.asarray(new_pos), np.asarray(ref_pos))
        assert np.asarray(idx).tolist() == np.asarray(ref_idx).tolist()
        for s, rs in zip(stats, ref_stats):
            assert np.asarray(s).tolist() == np.asarray(rs).tolist()
        np.testing.assert_allclose(np.asarray(en), np.asarray(ref_en),
                                   rtol=1e-12)


def test_replica_exchange_aux_travels_with_configurations(rng):
    """A solver cache passed as aux is permuted exactly like the
    positions: after swaps, the aux entry tagging configuration k sits in
    whatever slot holds configuration k."""
    n_rep, n_atom = 6, 5
    sys = harmonic_system(n_atom)
    params = sys.make_params()
    pos = jnp.asarray(rng.normal(size=(n_rep, n_atom, 3)))
    beta = jnp.asarray(1.0 / (0.8 + 0.1 * np.arange(n_rep)))
    rex = ReplicaExchange(even_odd_swap_sets(n_rep), n_rep)
    energy_of = jax.vmap(lambda p: sys.energy(p, params))
    # tag each slot's cache with its original configuration id, in two
    # different leaf shapes (belief-array-like and scalar-like)
    aux = {"node": (jnp.arange(n_rep, dtype=jnp.float32)[:, None, None]
                    * jnp.ones((n_rep, 3, 8), jnp.float32),
                    jnp.arange(n_rep, dtype=jnp.int32))}
    new_pos, idx, _, _, new_aux = rex.attempt_swaps(
        jax.random.PRNGKey(5), pos, jnp.arange(n_rep), beta, energy_of,
        slot_independent=True, aux=aux)
    # idx[s] = original slot whose configuration now sits in slot s
    idx = np.asarray(idx)
    np.testing.assert_allclose(np.asarray(new_pos), np.asarray(pos)[idx])
    np.testing.assert_array_equal(
        np.asarray(new_aux["node"][1]), idx.astype(np.int32))
    np.testing.assert_allclose(np.asarray(new_aux["node"][0][:, 0, 0]), idx)


def test_hamiltonian_selective_param_stacking(rng):
    """A Hamiltonian ensemble advanced with only the differing leaves
    stacked (stack_param_ensembles spec) matches the fully-stacked path
    exactly, and the spec names only the varied leaf."""
    from upside_md.md.sim import param_axes, stack_param_ensembles

    n_rep, n_atom = 3, 5
    sys = harmonic_system(n_atom)
    base = sys.make_params()
    per_slot = []
    for i in range(n_rep):
        p = jax.tree.map(lambda x: x, base)
        p["atom_pos_spring"]["spring_const"] = \
            base["atom_pos_spring"]["spring_const"] * (1.0 + 0.2 * i)
        per_slot.append(p)

    mixed, spec = stack_param_ensembles(per_slot)
    assert spec == frozenset({"['atom_pos_spring']['spring_const']"})
    assert mixed["atom_pos_spring"]["spring_const"].shape[0] == n_rep
    assert mixed["atom_pos_spring"]["x0"].ndim == 2      # shared, unstacked

    full = jax.tree.map(lambda *xs: jnp.stack(xs), *per_slot)
    pos0 = 0.4 * rng.normal(size=(n_rep, n_atom, 3))
    sim = Simulation(sys, dt=0.005, do_recenter=False)
    s_mixed = sim.initial_state(pos0, mixed, seed=3, temperature=0.7,
                                n_replica=n_rep)
    s_full = sim.initial_state(pos0, full, seed=3, temperature=0.7,
                               n_replica=n_rep)
    out_mixed = sim.advance(s_mixed, mixed, 4, True, spec)
    out_full = sim.advance(s_full, full, 4, True, True)
    np.testing.assert_array_equal(np.asarray(out_mixed.pos),
                                  np.asarray(out_full.pos))
    np.testing.assert_array_equal(
        np.asarray(sim.potential_energy(out_mixed, mixed, True, spec)),
        np.asarray(sim.potential_energy(out_full, full, True, True)))

    # vmapped energy with the axes tree matches per-slot evaluation
    axes = param_axes(mixed, spec)
    e_mixed = jax.vmap(sys.energy, in_axes=(0, axes))(out_mixed.pos, mixed)
    e_ref = jnp.stack([sys.energy(out_mixed.pos[i], per_slot[i])
                       for i in range(n_rep)])
    np.testing.assert_allclose(np.asarray(e_mixed), np.asarray(e_ref),
                               rtol=1e-6)


def test_parse_swap_sets_rejects_overlap():
    import pytest
    with pytest.raises(ValueError):
        parse_swap_sets(["0-1,1-2"], 4)
