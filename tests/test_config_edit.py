"""Post-hoc config editing (break_chains / add_target_information)."""

import h5py
import numpy as np
import jax.numpy as jnp
import pytest

from upside_md.config.builder import ConfigBuilder
from upside_md.config.edit import (add_target_information, break_chains,
                                       find_multichain_terms)
from upside_md.config.reader import load_system

SEQ = 'MKVLFEGARTIS'


def _plain_config(tmp_path, name='plain.up', seed=1):
    rng = np.random.default_rng(seed)
    b = ConfigBuilder(f'>x\n{SEQ}\n', seed=seed)
    b.add_backbone_springs()
    b.add_rama_map_pot(0.2 * rng.normal(size=(b.n_res, 12, 12)))
    return b.write(str(tmp_path / name)), b


def test_break_chains_matches_builder(tmp_path):
    """Editing a compiled config == building with add_chain_breaks."""
    edited, b1 = _plain_config(tmp_path, 'edited.up', seed=1)
    break_chains(edited, [6], jump_length_scale=4.0,
                 jump_rotation_scale=25.0)

    rng = np.random.default_rng(1)
    b2 = ConfigBuilder(f'>x\n{SEQ}\n', seed=1)
    b2.add_backbone_springs()
    b2.add_rama_map_pot(0.2 * rng.normal(size=(b2.n_res, 12, 12)))
    b2.add_chain_breaks([6], jump_length_scale=4.0,
                        jump_rotation_scale=25.0)
    native = b2.write(str(tmp_path / 'native.up'))

    with h5py.File(edited) as fe, h5py.File(native) as fn:
        for grp, ds in (('potential/dist_spring', 'id'),
                        ('potential/dist_spring', 'equil_dist'),
                        ('potential/angle_spring', 'id'),
                        ('potential/dihedral_spring', 'id'),
                        ('potential/rama_coord', 'id'),
                        ('chain_break', 'chain_first_residue'),
                        ('jump_moves', 'atom_range'),
                        ('jump_moves', 'sigma_trans'),
                        ('jump_moves', 'sigma_rot')):
            np.testing.assert_array_equal(
                np.asarray(fe[f'input/{grp}/{ds}']),
                np.asarray(fn[f'input/{grp}/{ds}']),
                err_msg=f'{grp}/{ds}')

    system, params, pos, aux = load_system(edited)
    total, _, _ = system.evaluate(jnp.asarray(pos), params)
    assert np.isfinite(float(total))
    assert 'jump_moves' in aux and 'chain_break' in aux


def test_break_chains_cuts_only_boundary_terms(tmp_path):
    path, b = _plain_config(tmp_path)
    with h5py.File(path) as f:
        n_dist = len(f['input/potential/dist_spring/id'])
        n_ang = len(f['input/potential/angle_spring/id'])
    break_chains(path, [6])
    starts = np.array([0, 18])
    with h5py.File(path) as f:
        ids = np.asarray(f['input/potential/dist_spring/id'])
        assert len(ids) == n_dist - 1           # one backbone bond cut
        assert not find_multichain_terms(ids, starts).any()
        ang = np.asarray(f['input/potential/angle_spring/id'])
        assert len(ang) == n_ang - 2            # two angles straddle
        assert not find_multichain_terms(ang, starts).any()
        rama = np.asarray(f['input/potential/rama_coord/id'])
        assert rama[6, 0] == -1 and rama[5, 4] == -1


def test_break_chains_rejects_multichain_hbond(tmp_path):
    rng = np.random.default_rng(0)
    b = ConfigBuilder(f'>x\n{SEQ}\n', seed=0)
    b.add_backbone_springs()
    b.add_hbond(hbond_energy=-2.0)
    path = b.write(str(tmp_path / 'hb.up'))
    with pytest.raises(ValueError, match='infer_H_O'):
        break_chains(path, [6])


def test_add_target_information(tmp_path):
    path, b = _plain_config(tmp_path)
    target = b.pos + 1.0
    add_target_information(path, target)
    with h5py.File(path) as f:
        np.testing.assert_allclose(np.asarray(f['target/pos']), target)
    with pytest.raises(ValueError, match='replace'):
        add_target_information(path, target)
    add_target_information(path, target + 1.0, replace=True)
    with pytest.raises(ValueError, match='shape'):
        add_target_information(path, target[:-3], replace=True)


def test_cli_roundtrip(tmp_path):
    from upside_md.config.edit import main
    path, b = _plain_config(tmp_path)
    main(['break-chains', path, '--chain-first-residue', '6',
          '--remove-pivot'])
    tgt = tmp_path / 'target.npy'
    np.save(tgt, b.pos)
    main(['add-target', path, '--target-structure', str(tgt)])
    with h5py.File(path) as f:
        assert 'target/pos' in f
        assert 'chain_break' in f['input']
    # from-file rerun picks up the recorded breaks
    main(['break-chains', path, '--chain-break-from-file'])
