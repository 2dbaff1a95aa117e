"""Rama dimer-library reading: mixture/product combining rules and sheet
mixing (upside_config.py:567-639 semantics)."""

import h5py
import numpy as np
import pytest

from upside_md.config.builder import (ConfigBuilder, mixture_potential,
                                          read_weighted_maps)


def make_library(path, rng, n_bin=12):
    restypes = ['ALA', 'GLY', 'LEU', 'PRO', 'CPR', 'ALL']
    dirs = ['left', 'right']
    with h5py.File(path, 'w') as f:
        for grp_name in ('coil', 'sheet'):
            g = f.create_group(grp_name)
            g.attrs['restype'] = np.asarray(restypes, 'S')
            g.attrs['dir'] = np.asarray(dirs, 'S')
            g.create_dataset('dimer_pot', data=0.3 * rng.normal(
                size=(len(restypes), 2, len(restypes), n_bin, n_bin)))
            g.create_dataset('dimer_weight', data=rng.uniform(
                0.5, 2.0, size=(len(restypes), 2, len(restypes))))
    return path


def test_mixture_potential_normalization(rng):
    pots = [rng.normal(size=(6, 6)), rng.normal(size=(6, 6))]
    mixed = mixture_potential([1.0, 3.0], pots)
    expect = -np.log(0.25 * np.exp(-pots[0]) + 0.75 * np.exp(-pots[1]))
    np.testing.assert_allclose(mixed, expect, atol=1e-10)


@pytest.mark.parametrize('mode', ['mixture', 'product'])
def test_read_weighted_maps(tmp_path, rng, mode):
    lib = make_library(str(tmp_path / 'rama.h5'), rng)
    seq = ['ALA', 'LEU', 'GLY', 'PRO', 'ALA']
    pots = read_weighted_maps(seq, lib, mode=mode)
    assert pots.shape == (5, 12, 12)
    # each map normalized: -log sum exp(-pot) == 0
    z = np.exp(-pots.astype(np.float64)).sum(axis=(-2, -1))
    np.testing.assert_allclose(-np.log(z), 0.0, atol=1e-4)


def test_sheet_mixing(tmp_path, rng):
    lib = make_library(str(tmp_path / 'rama.h5'), rng)
    seq = ['ALA', 'LEU', 'GLY', 'PRO', 'ALA']
    coil = read_weighted_maps(seq, lib)
    mixed_weak = read_weighted_maps(seq, lib, sheet_mixing=10.0)
    mixed_strong = read_weighted_maps(seq, lib, sheet_mixing=-10.0)
    # strong sheet energy (very negative) pulls far from the coil maps
    assert np.abs(mixed_weak - coil).max() < 0.01
    assert np.abs(mixed_strong - coil).max() > 0.1


def test_builder_from_library(tmp_path, rng):
    lib = make_library(str(tmp_path / 'rama.h5'), rng)
    b = ConfigBuilder('>x\nALGPA\n'.replace('ALGPA', 'ALGPA'), seed=0)
    b.add_backbone_springs()
    b.add_rama_map_pot_from_library(lib, sheet_mixing=-0.268)
    path = b.write(str(tmp_path / 'sys.up'))
    from upside_md.config.reader import load_system
    import jax.numpy as jnp
    system, params, pos, aux = load_system(path)
    assert np.isfinite(float(system.energy(jnp.asarray(pos), params)))
