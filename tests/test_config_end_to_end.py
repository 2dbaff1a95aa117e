"""End-to-end: build a .up config with the shipped parameter libraries,
load it through the reader, evaluate energies/forces, and run MD rounds.
This mirrors BASELINE config 1 (backbone-only) and config 2 (full
forcefield with rotamer BP + environment)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from upside_md.config.builder import (ConfigBuilder,
                                          uniform_rama_maps_from_reference)
from upside_md.config.reader import load_system
from upside_md.md.mc import PivotSampler
from upside_md.md.sim import Simulation

PARAM_DIR = '/root/reference/parameters'
RAMA_REF = f'{PARAM_DIR}/common/rama_reference.pkl'
SIDECHAIN = f'{PARAM_DIR}/ff_1/sidechain.h5'
ENVIRONMENT = f'{PARAM_DIR}/ff_1/environment.h5'

TRP_CAGE = 'NLYIQWLKDGGPSSGRPPPS'

needs_params = pytest.mark.skipif(not os.path.exists(SIDECHAIN),
                                  reason='reference parameters not mounted')


def build_backbone_config(tmp_path, seq=TRP_CAGE):
    b = ConfigBuilder(f'>x\n{seq}\n', seed=1)
    b.add_backbone_springs()
    b.add_rama_map_pot(uniform_rama_maps_from_reference(b.n_res, RAMA_REF))
    b.add_backbone_pairs()
    b.add_hbond(hbond_energy=-2.1119)
    return b.write(str(tmp_path / 'backbone.up'))


def build_full_config(tmp_path, seq=TRP_CAGE):
    b = ConfigBuilder(f'>x\n{seq}\n', seed=1)
    b.add_backbone_springs()
    b.add_rama_map_pot(uniform_rama_maps_from_reference(b.n_res, RAMA_REF))
    b.add_backbone_pairs()
    b.add_rotamer_sidechains(SIDECHAIN, SIDECHAIN, damping=0.4,
                             dynamic_1body=True)
    b.add_hbond(hbond_energy=-2.1119, coverage_library=SIDECHAIN)
    b.add_environment(ENVIRONMENT)
    b.add_rotamer_node()
    return b.write(str(tmp_path / 'full.up'))


@needs_params
def test_backbone_config_roundtrip(tmp_path):
    path = build_backbone_config(tmp_path)
    system, params, pos, aux = load_system(path)
    assert system.n_atom == 3 * len(TRP_CAGE)
    assert 'pivot_moves' in aux
    total, outputs, per_term = system.evaluate(jnp.asarray(pos), params)
    assert np.isfinite(float(total))
    expected_terms = {'dist_spring', 'angle_spring', 'dihedral_spring',
                      'rama_map_pot', 'backbone_pairs', 'hbond_energy'}
    assert expected_terms <= set(per_term)
    g = jax.grad(system.energy)(jnp.asarray(pos), params)
    assert np.all(np.isfinite(np.asarray(g)))


@needs_params
def test_backbone_md_runs_and_equipartitions(tmp_path):
    path = build_backbone_config(tmp_path)
    system, params, pos, aux = load_system(path)
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     frame_interval=0.27)
    state = sim.initial_state(pos, params, seed=7, temperature=0.85)
    kes, pes = [], []
    for _ in range(30):
        state = sim.advance(state, params, 10)
        kes.append(float(sim.kinetic_energy(state)))
        pes.append(float(sim.potential_energy(state, params)))
    assert np.all(np.isfinite(kes)) and np.all(np.isfinite(pes))
    ratio = np.mean(kes[10:]) / (1.5 * 0.85)
    assert abs(ratio - 1.0) < 0.25, ratio


@needs_params
def test_backbone_pivot_mc(tmp_path):
    path = build_backbone_config(tmp_path)
    system, params, pos, aux = load_system(path)
    pm = aux['pivot_moves']
    sampler = PivotSampler.from_tables(pm['pivot_atom'], pm['pivot_range'],
                                       pm['pivot_restype'],
                                       pm['proposal_pot'])
    from upside_md.md.mc import metropolis_step
    new_pos, acc = metropolis_step(
        jax.random.PRNGKey(0), jnp.asarray(pos), 1.0,
        lambda p: system.energy(p, params), sampler)
    assert np.all(np.isfinite(np.asarray(new_pos)))


@needs_params
def test_full_forcefield_energy_and_forces(tmp_path):
    path = build_full_config(tmp_path)
    system, params, pos, aux = load_system(path)
    total, outputs, per_term = system.evaluate(jnp.asarray(pos), params)
    assert np.isfinite(float(total))
    for name in ('rotamer', 'nonlinear_coupling_environment',
                 'hbond_energy', 'backbone_pairs'):
        assert name in per_term and np.isfinite(float(per_term[name])), name
    g = jax.grad(system.energy)(jnp.asarray(pos), params)
    assert np.all(np.isfinite(np.asarray(g)))

    # finite-difference check of the total force on a few coordinates
    def f(p):
        return float(system.energy(jnp.asarray(p), params))

    eps = 3e-5
    gn = np.asarray(g)
    scale = np.abs(gn).max()
    for (i, d) in [(5, 0), (20, 1), (40, 2)]:
        pp = np.array(pos, np.float64); pp[i, d] += eps
        pm_ = np.array(pos, np.float64); pm_[i, d] -= eps
        fd = (f(pp) - f(pm_)) / (2 * eps)
        assert abs(fd - gn[i, d]) / scale < 2e-3, (i, d, fd, gn[i, d])


@needs_params
def test_full_forcefield_md_short(tmp_path):
    path = build_full_config(tmp_path)
    system, params, pos, aux = load_system(path)
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135)
    state = sim.initial_state(pos, params, seed=11, temperature=0.85)
    state = sim.advance(state, params, 10)
    assert np.all(np.isfinite(np.asarray(state.pos)))
    assert np.isfinite(float(sim.potential_energy(state, params)))


@needs_params
def test_10A_cutoff_family(tmp_path):
    """BASELINE config 3: the PARAM_10A_CUTOFF parameter family, resolved
    at runtime from table shapes (the reference needs a rebuild)."""
    from upside_md.bench_systems import build_10A_system
    system, params, pos, aux = build_10A_system(seq='MTYKLILNGKTLKGETTTE')
    total, outputs, per_term = system.evaluate(jnp.asarray(pos), params)
    assert np.isfinite(float(total))
    assert 'rotamer' in per_term
    g = jax.grad(system.energy)(jnp.asarray(pos), params)
    assert np.all(np.isfinite(np.asarray(g)))
