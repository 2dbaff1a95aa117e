"""The upside_config-compatible CLI (config/cli.py) mirrors the reference
flag surface (py/upside_config.py:1199-1671): a reference-style command
line must produce a loading, running .up file."""

import os

import h5py
import numpy as np
import pytest

from upside_md.config.cli import main as config_main, parse_segments
from upside_md.config.reader import load_system

from test_rama_library import make_library

PARAM_DIR = os.environ.get("UPSIDE_PARAM_DIR", "/root/reference/parameters")
SIDECHAIN = f"{PARAM_DIR}/ff_1/sidechain.h5"
ENVIRONMENT = f"{PARAM_DIR}/ff_1/environment.h5"

needs_params = pytest.mark.skipif(
    not os.path.exists(SIDECHAIN), reason="reference parameters not mounted")


def test_parse_segments():
    np.testing.assert_array_equal(parse_segments("10-13,17,19-21"),
                                  [10, 11, 12, 13, 17, 19, 20, 21])


def _write_fasta(tmp_path, seq):
    p = tmp_path / "seq.fasta"
    p.write_text(f">test\n{seq}\n")
    return str(p)


def test_backbone_only_cli(tmp_path, rng):
    """Reference-style minimal command line: springs + hbond + sterics."""
    fasta = _write_fasta(tmp_path, "ALGPAKEV")
    out = str(tmp_path / "sys.up")
    config_main(["--fasta", fasta, "--output", out,
                 "--hbond-energy", "-2.1"])
    system, params, pos, aux = load_system(out)
    names = {s.node_type.name for s in system.specs}
    assert {"dist_spring", "angle_spring", "dihedral_spring", "infer_H_O",
            "protein_hbond", "hbond_energy", "backbone_pairs",
            "affine_alignment"} <= names
    e = float(system.energy(pos, params))
    assert np.isfinite(e)
    # flag archive written like the reference (upside_config.py:1464-1467)
    with h5py.File(out, "r") as f:
        assert f["input/args"].attrs["hbond_energy"] == -2.1
        assert "invocation" in f["input/args"].attrs


@needs_params
def test_full_forcefield_cli(tmp_path, rng):
    """The BASELINE-config-2 style invocation: rotamer BP sidechains +
    environment + Rama library + hbond + sterics, all from flags."""
    seq = "ALGPALLGAL"  # restypes limited to the synthetic rama library
    fasta = _write_fasta(tmp_path, seq)
    rama_lib = make_library(str(tmp_path / "rama.h5"), rng, n_bin=12)
    secstr = tmp_path / "bias.dat"
    secstr.write_text("residue secstr energy\n2 helix -0.5\n4 sheet 0.3\n")
    out = str(tmp_path / "sys.up")
    config_main([
        "--fasta", fasta, "--output", out,
        "--hbond-energy", "-2.1119",
        "--rama-library", rama_lib,
        "--rama-sheet-mixing-energy", "0.5",
        "--secstr-bias", str(secstr),
        "--rotamer-placement", SIDECHAIN,
        "--rotamer-interaction", SIDECHAIN,
        "--environment-potential", ENVIRONMENT,
        "--dynamic-rotamer-1body",
        "--rotamer-solve-damping", "0.4",
    ])
    system, params, pos, aux = load_system(out)
    names = {s.node_type.name for s in system.specs}
    assert {"rotamer", "rama_map_pot", "protein_hbond", "hbond_coverage",
            "environment_coverage", "nonlinear_coupling"} <= names
    assert "pivot_moves" in aux  # proposal tables from the Rama pot
    e = float(system.energy(pos, params))
    assert np.isfinite(e)


def test_tables_and_restraints_cli(tmp_path, rng):
    """Table-file flags: z-flat-bottom, tension, restraint groups with an
    initial structure, contact energies."""
    import pickle

    seq = "ALGPAKEV"
    fasta = _write_fasta(tmp_path, seq)
    n_atom = 3 * len(seq)
    pos0 = np.cumsum(rng.normal(size=(n_atom, 3)), axis=0) + \
        3.0 * np.arange(n_atom)[:, None] * np.array([1.0, 0, 0])
    init = tmp_path / "init.pkl"
    init.write_bytes(pickle.dumps(pos0[:, :, None].astype('f4')))

    zfb = tmp_path / "zfb.dat"
    zfb.write_text("residue z0 radius spring_constant\n1 0.0 5.0 2.0\n")
    contacts = tmp_path / "contacts.dat"
    contacts.write_text("residue1 residue2 energy distance "
                        "transition_width\n0 7 -1.5 8.0 2.0\n")
    out = str(tmp_path / "sys.up")
    config_main(["--fasta", fasta, "--output", out,
                 "--initial-structure", str(init),
                 "--z-flat-bottom", str(zfb),
                 "--contact-energies", str(contacts),
                 "--restraint-group", "0-3",
                 "--restraint-spring-constant", "3.0",
                 "--no-backbone"])
    system, params, pos, aux = load_system(out)
    names = {s.node_type.name for s in system.specs}
    assert {"z_flat_bottom", "contact", "dist_spring"} <= names
    np.testing.assert_allclose(np.asarray(pos), pos0, atol=1e-5)
    assert np.isfinite(float(system.energy(pos, params)))


def test_fix_rotamer_restype_check(tmp_path):
    from upside_md.config.cli import _read_fix_rotamer
    table = tmp_path / "fix.dat"
    table.write_text("residue restype rotamer\n0 ALA 1\n")
    with pytest.raises(SystemExit):
        _read_fix_rotamer(str(table), np.array(["GLY", "ALA"]))
    assert _read_fix_rotamer(str(table),
                             np.array(["ALA", "GLY"])) == {0: 1}


def test_torus_dbn_cli(tmp_path, rng):
    """--torus-dbn-library builds the TorusDBN + fixed-HMM Rama prior
    (the flag the reference defines but leaves commented out,
    upside_config.py:1244); --rama-sheet-library is accepted as the
    reference's parsed-but-unused compatibility flag."""
    seq = "ALGKAVEL"
    fasta = _write_fasta(tmp_path, seq)
    n_state, n_restype = 3, 21
    lib = tmp_path / "torus.h5"
    bp = rng.normal(size=(n_state, 6))
    bp[:, 1] = np.abs(bp[:, 1])
    bp[:, 3] = np.abs(bp[:, 3])
    restype_order = ["ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU",
                     "GLY", "HIS", "ILE", "LEU", "LYS", "MET", "PHE",
                     "PRO", "SER", "THR", "TRP", "TYR", "VAL", "CPR"]
    with h5py.File(lib, "w") as f:
        f["restype_order"] = np.array(restype_order, dtype="S")
        f["basin_param"] = bp
        f["aa_basin_energy"] = rng.normal(size=(n_restype, n_state))
        f["transition_energy"] = rng.normal(size=(n_state, n_state))
    out = str(tmp_path / "sys.up")
    config_main(["--fasta", fasta, "--output", out,
                 "--torus-dbn-library", str(lib),
                 "--rama-sheet-library", str(lib)])
    system, params, pos, aux = load_system(out)
    names = {s.node_type.name for s in system.specs}
    assert {"torus_dbn", "fixed_hmm", "rama_coord"} <= names
    assert np.isfinite(float(system.energy(pos, params)))
