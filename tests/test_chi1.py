"""chi1 prediction pipeline end-to-end (BASELINE config 5 capability)."""

import os

import numpy as np
import pytest

from upside_md.chi1 import Chi1Predict, predict_chi1_from_pdb
from upside_md.config.builder import random_initial_config

from test_io import synthetic_pdb

SIDECHAIN = '/root/reference/parameters/ff_1/sidechain.h5'
needs_params = pytest.mark.skipif(not os.path.exists(SIDECHAIN),
                                  reason='reference parameters not mounted')

SEQ3 = ['MET', 'LYS', 'VAL', 'LEU', 'PHE', 'GLU', 'GLY', 'ALA', 'ARG',
        'THR', 'ILE', 'SER']


@needs_params
def test_chi1_cli(tmp_path):
    """The predict_chi1 CLI writes the reference's column layout
    (predict_chi1.py:118-130) and prints the evaluation-time metric."""
    from upside_md.chi1 import main

    coords = random_initial_config(len(SEQ3), seed=4)
    pdb = tmp_path / "in.pdb"
    pdb.write_text(synthetic_pdb(SEQ3, coords))
    out = tmp_path / "out.chi"
    main([str(pdb), SIDECHAIN, str(out)])
    lines = out.read_text().strip().splitlines()
    assert lines[0].split() == [
        "residue", "restype", "chain", "resnum", "chi1_prob0",
        "chi1_prob1", "chi1_prob2", "chi1_from_input_file"]
    assert len(lines) == len(SEQ3) + 1
    for ln in lines[1:]:
        cols = ln.split()
        probs = [float(c) for c in cols[4:7]]
        assert abs(sum(probs) - 1.0) < 2e-2


@needs_params
def test_chi1_predictor_partition():
    pred = Chi1Predict(SIDECHAIN)
    # every non-ALA/GLY restype has its rotamer states partitioned into
    # 3 chi1 bins covering all states
    for aa, parts in pred.chi1_partition.items():
        states = sorted(int(s) for p in parts for s in p)
        assert states == sorted(set(states))


@needs_params
def test_chi1_from_pdb_pipeline():
    coords = random_initial_config(len(SEQ3), seed=4)
    pdb = synthetic_pdb(SEQ3, coords)
    chi1_prob, info, elapsed = predict_chi1_from_pdb(pdb, SIDECHAIN)
    assert chi1_prob.shape == (len(SEQ3), 3)
    assert np.all(np.isfinite(chi1_prob))
    # ALA/GLY get deterministic state 0
    for i, aa in enumerate(SEQ3):
        if aa in ('ALA', 'GLY'):
            np.testing.assert_allclose(chi1_prob[i], [1, 0, 0])
        else:
            # probabilities over chi1 bins sum to ~1
            assert abs(chi1_prob[i].sum() - 1.0) < 2e-2, (i, aa, chi1_prob[i])
