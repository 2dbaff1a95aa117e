"""Spec conformance: the .up files our builder writes must contain the
dataset/attribute names the REFERENCE C++ readers consume.  The manifest
below is extracted from the reference source (file:line cited per entry),
not from this repo's builder or reader — so a shared wrong assumption
between our writer and our reader cannot hide a spec break.
"""

import h5py
import numpy as np
import pytest

from upside_md.config.builder import ConfigBuilder

# group name -> (required datasets, required attrs), from the reference
# readers' traverse_dset/check_size/read_attribute calls
REFERENCE_MANIFEST = {
    # bonds.cpp:271-279 (DistSpring)
    "dist_spring": ({"id", "equil_dist", "spring_const", "bonded_atoms"},
                    set()),
    # bonds.cpp:448-455 (AngleSpring; equil_dist holds the equilibrium dot)
    "angle_spring": ({"id", "equil_dist", "spring_const"}, set()),
    # bonds.cpp:510-517 (DihedralSpring)
    "dihedral_spring": ({"id", "equil_dist", "spring_const"}, set()),
    # bonds.cpp:190-210 (RamaCoord)
    "rama_coord": ({"id"}, set()),
    # rama_map_pot.cpp:27-49
    "rama_map_pot": ({"residue_id", "rama_map_id", "rama_pot"}, set()),
    # backbone_steric.cpp (BackbonePairs)
    "backbone_pairs": ({"id", "n_atom", "ref_pos"}, set()),
    # hbond.cpp:28-46 (Infer_H_O: donors/acceptors subgroups)
    "infer_H_O": ({"donors/id", "donors/bond_length",
                   "acceptors/id", "acceptors/bond_length"}, set()),
    # hbond.cpp:151-230 + interaction_graph.h (ProteinHBond igraph)
    "protein_hbond": ({"index1", "index2", "type1", "type2",
                       "id1", "id2", "interaction_param"}, set()),
    # hbond.cpp:241-286 (HBondCoverage igraph)
    "hbond_coverage": ({"index1", "index2", "type1", "type2",
                        "id1", "id2", "interaction_param"}, set()),
    # hbond.cpp:430-444 (HBondEnergy)
    "hbond_energy": (set(), {"protein_hbond_energy"}),
    # placement.cpp:223-253
    "placement_fixed_point_vector_only":
        ({"affine_residue", "layer_index", "placement_data",
          "rama_residue"}, set()),
    "placement_scalar":
        ({"affine_residue", "layer_index", "placement_data",
          "rama_residue"}, set()),
    # rotamer.cpp:560-660: solver attrs + igraph subgroup pair_interaction.
    # The rotamer igraph is SYMMETRIC, so the reference reads the
    # unsuffixed index/type/id (interaction_graph.h:308, 363-370).
    "rotamer": ({"pair_interaction/index", "pair_interaction/type",
                 "pair_interaction/id",
                 "pair_interaction/interaction_param"},
                {"max_iter", "tol", "damping", "iteration_chunk_size"}),
}

# environment.cpp readers, exercised when the environment library exists
ENV_MANIFEST = {
    # environment.cpp:30-60 (EnvironmentCoverage igraph)
    "environment_coverage": ({"index1", "index2", "type1", "type2",
                              "id1", "id2", "interaction_param"}, set()),
    # environment.cpp:120-140 (WeightedPos)
    "weighted_pos": ({"index_pos", "index_weight"}, set()),
    # environment.cpp:240-268 (uniform_transform spline)
    "uniform_transform": ({"bspline_coeff"}, set()),
    # environment.cpp:260-278 (linear couplings)
    "linear_coupling_with_inactivation": ({"couplings", "coupling_types"},
                                          {"inactivation_dim"}),
}

SEQ = "NLYIQWLKDGGPSSGRPPPS"
SIDECHAIN = "/root/reference/parameters/ff_1/sidechain.h5"
ENVIRONMENT = "/root/reference/parameters/ff_1/environment.h5"
RAMA = "/root/reference/parameters/common/rama_reference.pkl"


@pytest.fixture(scope="module")
def full_config(tmp_path_factory):
    import os
    if not os.path.exists(SIDECHAIN):
        pytest.skip("reference parameter libraries not mounted")
    from upside_md.config.builder import \
        uniform_rama_maps_from_reference
    path = str(tmp_path_factory.mktemp("conf") / "full.up")
    b = ConfigBuilder(f">x\n{SEQ}\n", seed=1)
    b.add_backbone_springs()
    b.add_rama_map_pot(uniform_rama_maps_from_reference(b.n_res, RAMA))
    b.add_backbone_pairs()
    b.add_rotamer_sidechains(SIDECHAIN, SIDECHAIN, damping=0.4,
                             dynamic_1body=True)
    b.add_hbond(hbond_energy=-2.0, coverage_library=SIDECHAIN)
    import os
    if os.path.exists(ENVIRONMENT):
        b.add_environment(ENVIRONMENT)
    b.add_rotamer_node()
    b.write(path)
    return path


def _check(f, manifest):
    pot = f["input/potential"]
    missing = {}
    for group, (datasets, attrs) in manifest.items():
        matches = [g for g in pot if g == group]
        if not matches:
            continue  # groups are config-dependent; presence tested below
        g = pot[group]
        miss = [d for d in datasets if d not in g]
        miss += [f"@{a}" for a in attrs if a not in g.attrs]
        if miss:
            missing[group] = miss
    assert not missing, missing


def test_full_config_matches_reference_readers(full_config):
    with h5py.File(full_config, "r") as f:
        pot = f["input/potential"]
        # every manifest group the full config is expected to produce
        for group in ("dist_spring", "angle_spring", "dihedral_spring",
                      "rama_coord", "rama_map_pot", "backbone_pairs",
                      "infer_H_O", "protein_hbond", "hbond_coverage",
                      "hbond_energy", "rotamer"):
            assert group in pot, f"builder did not emit group {group}"
        _check(f, REFERENCE_MANIFEST)
        _check(f, ENV_MANIFEST)
        # top-level layout the reference engine requires
        # (deriv_engine.cpp:213-229, main.cpp:480-520)
        assert "input/pos" in f
        assert f["input/pos"].shape[2] == 1 or f["input/pos"].ndim == 3
        # every potential group must declare its arguments
        for name in pot:
            assert "arguments" in pot[name].attrs, name


def test_rotamer_solver_attrs_are_reference_typed(full_config):
    with h5py.File(full_config, "r") as f:
        g = f["input/potential/rotamer"]
        assert int(g.attrs["max_iter"]) > 0
        assert 0.0 <= float(g.attrs["damping"]) < 1.0
        assert float(g.attrs["tol"]) > 0.0
        ip = g["pair_interaction"]
        table = np.asarray(ip["interaction_param"])
        assert table.ndim == 3   # (n_type1, n_type2, n_knot)
        # bead ids carry the packed (residue, n_rot, rot) fields
        # (rotamer.cpp:565-577)
        ids = np.asarray(ip["id"])
        rot = ids & 0xF
        n_rot = (ids >> 4) & 0xF
        assert (rot < np.maximum(n_rot, 1)).all()
