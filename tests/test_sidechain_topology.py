"""Side-chain internal-coordinate topology (all 20 restypes) and the
end-to-end sidechain-library regeneration pipeline (reference
generate_from_rotamer.cpp res_func_map + compute_rotamer_pos.cpp +
compute_rotamer_centers.cpp)."""

import jax.numpy as jnp
import numpy as np

from upside_md.sidechain_topology import (N_CHI, SIDECHAIN_TOPOLOGY,
                                              atom_names, deg,
                                              residue_atoms)


def test_all_twenty_restypes_build():
    for rt in SIDECHAIN_TOPOLOGY:
        atoms = residue_atoms(rt, psi=0.3, chi=(0.5, -1.0, 2.0, 0.1))
        names = atom_names(rt)
        assert atoms.shape == (len(names), 3)
        assert np.all(np.isfinite(atoms))
    assert len(SIDECHAIN_TOPOLOGY) == 20


def test_bond_lengths_match_topology():
    """Every grown atom sits at its specified bond length from its
    parent — the TAB construction invariant."""
    for rt in ("ARG", "TRP", "ILE", "PRO"):
        names = atom_names(rt)
        atoms = residue_atoms(rt, psi=-0.7, chi=(1.1, 0.4, -2.0, 0.9))
        idx = {n: i for i, n in enumerate(names)}
        rows = SIDECHAIN_TOPOLOGY[rt]
        for name, parent, _, _, bond in rows:
            d = np.linalg.norm(atoms[idx[name]] - atoms[idx[parent]])
            np.testing.assert_allclose(d, bond, atol=1e-5)
    # backbone lengths (generate_from_rotamer.cpp place_bb)
    atoms = residue_atoms("ALA", psi=0.0)
    idx = {n: i for i, n in enumerate(atom_names("ALA"))}
    np.testing.assert_allclose(
        np.linalg.norm(atoms[idx["CA"]] - atoms[idx["N"]]), 1.45, atol=1e-5)
    np.testing.assert_allclose(
        np.linalg.norm(atoms[idx["C"]] - atoms[idx["CA"]]), 1.53, atol=1e-5)


def test_chi_rotations_move_only_downstream_atoms():
    names = atom_names("LYS")
    a0 = residue_atoms("LYS", psi=0.2, chi=(0.3, 0.7, -0.4, 1.0))
    a1 = residue_atoms("LYS", psi=0.2, chi=(0.3, 0.7, -0.4, 2.5))
    idx = {n: i for i, n in enumerate(names)}
    # chi4 rotates NZ only
    assert np.linalg.norm(a1[idx["NZ"]] - a0[idx["NZ"]]) > 0.3
    for fixed in ("N", "CA", "C", "CB", "CG", "CD", "CE"):
        np.testing.assert_allclose(a1[idx[fixed]], a0[idx[fixed]],
                                   atol=1e-6)
    assert N_CHI["LYS"] == 4 and N_CHI["SER"] == 1 and N_CHI["ALA"] == 0


def test_library_regeneration_end_to_end(tmp_path, rng):
    """Rotamer samples -> generated sidechain.h5 -> config builder ->
    loaded system -> BP free energy and forces run (VERDICT item 7)."""
    from upside_md.config.builder import ConfigBuilder
    from upside_md.config.reader import load_system
    from upside_md.param_gen import generate_sidechain_library

    seq1 = "VLSK"
    three = {"V": "VAL", "L": "LEU", "S": "SER", "K": "LYS"}
    samples = {}
    for aa in set(seq1):
        rt = three[aa]
        n_rot = min(3, max(N_CHI[rt], 1) + 1)
        n = 60 * n_rot
        rot = rng.integers(0, n_rot, n)
        # well-separated chi1 basins per rotamer class
        chi = np.zeros((n, 4))
        chi[:, 0] = (-np.pi + (rot + 0.5) * 2 * np.pi / n_rot +
                     0.1 * rng.normal(size=n))
        for c in range(1, 4):
            chi[:, c] = 0.5 * rng.normal(size=n)
        samples[rt] = dict(chi=chi, rotamer=rot,
                           phi=rng.uniform(-np.pi, np.pi, n),
                           psi=rng.uniform(-np.pi, np.pi, n),
                           prob=np.ones(n))

    lib = str(tmp_path / "generated_sidechain.h5")
    generate_sidechain_library(lib, samples, n_bead=2)

    b = ConfigBuilder(f">x\n{seq1}\n", seed=2)
    b.add_backbone_springs()
    rng2 = np.random.default_rng(0)
    b.add_rama_map_pot(np.tile(0.3 * rng2.normal(size=(1, 72, 72)),
                               (b.n_res, 1, 1)))
    b.add_rotamer_sidechains(lib, lib, damping=0.4, dynamic_1body=True)
    b.add_rotamer_node()
    path = str(tmp_path / "gen.up")
    b.write(path)

    system, params, pos, aux = load_system(path)
    e = float(system.energy(jnp.asarray(pos), params))
    g = np.asarray(system.deriv(jnp.asarray(pos), params))
    assert np.isfinite(e)
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0
