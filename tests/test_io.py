"""PDB parsing, chi1 pipeline, and trajectory logging."""

import numpy as np
import pytest

from upside_md.config.builder import random_initial_config
from upside_md.io.logger import H5Logger
from upside_md.io.pdb import extract_initial_structure


def synthetic_pdb(seq_three, coords):
    """Minimal N/CA/C-only PDB text."""
    lines = []
    serial = 1
    for r, restype in enumerate(seq_three):
        for name, xyz in zip(('N', 'CA', 'C'), coords[3 * r:3 * r + 3]):
            lines.append(
                f"ATOM  {serial:5d} {name:^4s}{restype:>4s} A{r + 1:4d}    "
                f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00")
            serial += 1
    lines.append("END")
    return "\n".join(lines)


def test_pdb_roundtrip():
    seq = ['MET', 'ALA', 'LEU', 'GLY', 'LYS']
    coords = random_initial_config(5, seed=3)
    text = synthetic_pdb(seq, coords)
    info = extract_initial_structure(text, recenter=False)
    assert info['sequence'] == seq
    assert info['fasta'] == 'MALGK'
    np.testing.assert_allclose(info['coords'], coords, atol=2e-3)
    assert info['chain_first_residue'] == []


def test_pdb_chain_break():
    seq = ['MET', 'ALA', 'LEU', 'GLY']
    coords = random_initial_config(4, seed=3)
    coords[6:] += 50.0  # break between residues 1 and 2
    text = synthetic_pdb(seq, coords)
    with pytest.raises(ValueError):
        extract_initial_structure(text)
    info = extract_initial_structure(text, allow_unexpected_breaks=True)
    assert info['chain_first_residue'] == [2]


def test_h5_logger_roundtrip(tmp_path):
    import h5py
    path = str(tmp_path / "traj.up")
    with h5py.File(path, 'w') as f:
        f.create_group('input')
    with H5Logger(path, buffer_frames=3) as lg:
        for i in range(7):
            lg.log_frame('pos', np.full((1, 4, 3), float(i)))
            lg.log_frame('potential', np.array([float(i)]))
    with h5py.File(path, 'r') as f:
        assert f['output/pos'].shape == (7, 1, 4, 3)
        assert f['output/pos'][5, 0, 0, 0] == 5.0
        assert f['output/potential'].shape == (7, 1)
    # resume semantics: /output renamed to /output_previous_0
    with H5Logger(path) as lg:
        lg.log_frame('pos', np.zeros((1, 4, 3)))
    with h5py.File(path, 'r') as f:
        assert 'output_previous_0' in f
        assert f['output/pos'].shape == (1, 1, 4, 3)
