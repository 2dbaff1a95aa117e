"""Integrator variants, force clipping, annealing schedule, logger levels."""

import numpy as np
import jax.numpy as jnp

from upside_md import build_system
from upside_md.md.integrator import INTEGRATOR_COEFFS, clip_force
from upside_md.md.sim import Simulation

from helpers import spec


def harmonic(n_atom, k=3.0):
    s = spec("atom_pos_spring", ["pos"],
             {"id": np.arange(n_atom, dtype=np.int32)},
             {"x0": np.zeros((n_atom, 3)),
              "spring_const": np.full(n_atom, k)})
    return build_system(n_atom, [s])


def test_integrator_coefficients():
    mom_w, pos_w = INTEGRATOR_COEFFS["verlet"]
    np.testing.assert_allclose(mom_w, [1, 1, 1])
    np.testing.assert_allclose(pos_w, [1, 1, 1])
    mom_w, pos_w = INTEGRATOR_COEFFS["predescu"]
    # Predescu et al. 2012 coefficients (deriv_engine.cpp:176-180)
    a, b = 0.108991425403425322, 0.290485609075128726
    np.testing.assert_allclose(mom_w, [1.5 - 3 * a, 1.5 - 3 * a, 6 * a])
    np.testing.assert_allclose(pos_w, [3 * b, 3 - 6 * b, 3 * b])
    assert abs(sum(mom_w) - 3) < 1e-12 and abs(sum(pos_w) - 3) < 1e-12


def test_predescu_energy_conservation(rng):
    sys_ = harmonic(6)
    sim = Simulation(sys_, dt=0.005, thermostat_interval=1e10,
                     do_recenter=False, integrator="predescu")
    params = sys_.make_params()
    state = sim.initial_state(0.5 * rng.normal(size=(6, 3)), params, seed=1,
                              temperature=1.0)
    state = sim.advance(state, params, 1)
    e0 = float(sim.potential_energy(state, params)) + \
        0.5 * float(jnp.sum(state.mom ** 2))
    state = sim.advance(state, params, 300)
    e1 = float(sim.potential_energy(state, params)) + \
        0.5 * float(jnp.sum(state.mom ** 2))
    assert abs(e1 - e0) / abs(e0) < 2e-3


def test_force_clipping():
    d = jnp.asarray([[100.0, 0.0, 0.0], [0.01, 0.0, 0.0]])
    clipped = np.asarray(clip_force(d, max_force=1.0))
    # atan clip: large forces asymptote to max_force, small pass through
    assert clipped[0, 0] < 1.0
    assert abs(clipped[1, 0] - 0.01) < 1e-3
    assert np.allclose(np.asarray(clip_force(d, 0.0)), np.asarray(d))


def test_annealing_schedule(rng):
    sys_ = harmonic(4)
    params = sys_.make_params()
    sim = Simulation(sys_, dt=0.01, duration=30.0, thermostat_interval=0.03,
                     anneal_factor=0.25, do_recenter=False)
    state = sim.initial_state(0.1 * rng.normal(size=(4, 3)), params, seed=2,
                              temperature=2.0)
    # at the end of the run the temperature approaches factor * T0
    state = sim.advance(state, params, sim.n_round)
    t_end = float(state.temperature)
    assert abs(t_end - 0.5) < 0.05, t_end
    # sqrt-space midpoint (main.cpp:437-443)
    state2 = sim.initial_state(0.1 * rng.normal(size=(4, 3)), params, seed=2,
                               temperature=2.0)
    state2 = sim.advance(state2, params, sim.n_round // 2)
    expect_mid = (0.5 * (np.sqrt(2.0) + np.sqrt(0.5))) ** 2
    assert abs(float(state2.temperature) - expect_mid) < 0.1
