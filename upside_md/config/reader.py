"""Load a `.up` system (HDF5 file or in-memory tree) into a System.

The `.up` spec is defined by the reference's upside_config.py (the group
layout under /input/potential with `arguments` attrs wiring the DAG) and
consumed by initialize_engine_from_hdf5 (src/deriv_engine.cpp:195-270).
This reader keeps byte-level compatibility with that spec so configs built
by existing pipelines load unchanged.

Each node type has a small translator from its HDF5 group to the pure
consts/params of the JAX node library; spline-table parameters that the
reference fits at load time (rama maps, membrane z-profiles, placement
surfaces) are fitted here on the host in float64.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .tree import Group
from ..nodes.base import NodeSpec, resolve_node_type
from ..nodes.membrane import make_membrane_params
from ..nodes.placement import make_rama_placement_params
from ..nodes.rama import make_rama_map_params
from ..nodes.rotamer import make_rotamer_consts
from ..system import System


def _a(ds):
    return np.asarray(ds)


def _i(ds):
    return np.asarray(ds).astype(np.int32)


def _args(grp):
    return [x.decode() if isinstance(x, bytes) else str(x)
            for x in grp.attrs["arguments"]]


# --------------------------------------------------------------------------
# per-node-type translators: grp -> (consts, params)
# --------------------------------------------------------------------------

def _read_pos_spring(grp):
    return ({"id": _i(grp["id"])},
            {"x0": _a(grp["x0"]), "spring_const": _a(grp["spring_const"])})


def _read_tension(grp):
    return ({"atom": _i(grp["atom"])},
            {"tension_coeff": _a(grp["tension_coeff"])})


def _read_afm(grp):
    return ({"atom": _i(grp["atom"]),
             "time_initial": float(grp["pulling_vel"].attrs["time_initial"]),
             "time_step": float(grp["pulling_vel"].attrs["time_step"])},
            {"spring_const": _a(grp["spring_const"]),
             "starting_tip_pos": _a(grp["starting_tip_pos"]),
             "pulling_vel": _a(grp["pulling_vel"])})


def _read_dist_spring(grp):
    return ({"id": _i(grp["id"]), "bonded_atoms": _i(grp["bonded_atoms"])},
            {"equil_dist": _a(grp["equil_dist"]),
             "spring_const": _a(grp["spring_const"])})


def _read_angle_spring(grp):
    return ({"id": _i(grp["id"])},
            {"equil_dp": _a(grp["equil_dist"]),
             "spring_const": _a(grp["spring_const"])})


def _read_dihedral_spring(grp):
    return ({"id": _i(grp["id"])},
            {"equil_dihedral": _a(grp["equil_dist"]),
             "spring_const": _a(grp["spring_const"])})


def _read_cavity_radial(grp):
    return ({"id": _i(grp["id"])},
            {"radius": _a(grp["radius"]),
             "spring_const": _a(grp["spring_constant"])})


def _read_z_flat_bottom(grp):
    return ({"atom": _i(grp["atom"])},
            {"z0": _a(grp["z0"]), "radius": _a(grp["radius"]),
             "spring_const": _a(grp["spring_constant"])})


def _read_rama_coord(grp):
    ids = _i(grp["id"])
    dummy = np.zeros((ids.shape[0], 2), bool)
    dummy[:, 0] = ids[:, 0] == -1
    dummy[:, 1] = ids[:, 4] == -1
    ids = ids.copy()
    ids[dummy[:, 0], 0] = 0
    ids[dummy[:, 1], 4] = 0
    return ({"id": ids, "dummy": dummy}, {})


def _read_rama_map_pot(grp):
    raw = _a(grp["rama_pot"]).astype(np.float64)
    return ({"residue_id": _i(grp["residue_id"]),
             "rama_map_id": _i(grp["rama_map_id"]),
             "raw_map": raw,
             "log_pot": int(grp.attrs.get("log_pot", 1))},
            make_rama_map_params(raw))


def _read_affine_alignment(grp):
    return ({"atoms": _i(grp["atoms"]), "ref_geom": _a(grp["ref_geom"])}, {})


def _read_backbone_pairs(grp):
    ref_pos = _a(grp["ref_pos"]).astype(np.float64)
    n_atom = _i(grp["n_atom"])
    atom_mask = np.arange(4)[None, :] < n_atom[:, None]
    ref_pos = np.where(np.isfinite(ref_pos), ref_pos, 0.0)
    return ({"id": _i(grp["id"]), "ref_pos": ref_pos,
             "atom_mask": atom_mask}, {})


def _read_infer_h_o(grp):
    don, acc = grp["donors"], grp["acceptors"]
    ids = np.concatenate([_i(don["id"]), _i(acc["id"])], axis=0)
    bl = np.concatenate([_a(don["bond_length"]), _a(acc["bond_length"])])
    return ({"id": ids, "bond_length": bl,
             "n_donor": _i(don["id"]).shape[0],
             "donor_residue": _i(don["residue"]),
             "acceptor_residue": _i(acc["residue"])}, {})


def _read_igraph_pair(grp, symmetric):
    """index/type/id arrays + interaction_param, as InteractionGraph reads
    them (interaction_graph.h:305-381)."""
    if symmetric:
        c = {"index": _i(grp["index"]), "type": _i(grp["type"]),
             "id": _i(grp["id"])}
    else:
        c = {"index1": _i(grp["index1"]), "type1": _i(grp["type1"]),
             "id1": _i(grp["id1"]),
             "index2": _i(grp["index2"]), "type2": _i(grp["type2"]),
             "id2": _i(grp["id2"])}
    return c, {"interaction_param": _a(grp["interaction_param"])}


def _read_protein_hbond(grp):
    return _read_igraph_pair(grp, symmetric=False)


def _read_hbond_energy(grp):
    return ({}, {"protein_hbond_energy":
                 np.float32(grp.attrs["protein_hbond_energy"])})


def _read_radial(grp):
    return _read_igraph_pair(grp, symmetric=True)


def _read_contact(grp):
    return ({"id": _i(grp["id"])},
            {"energy": _a(grp["energy"]), "distance": _a(grp["distance"]),
             "width": _a(grp["width"])})


def _read_placement_fixed(grp):
    consts = {"affine_residue": _i(grp["affine_residue"]),
              "layer_index": _i(grp["layer_index"])}
    for extra in ("beadtype_seq", "id_seq"):
        if extra in grp:
            consts[extra] = np.asarray(grp[extra])
    return consts, {"placement_data": _a(grp["placement_data"])}


def _read_placement_rama(grp):
    consts = {"affine_residue": _i(grp["affine_residue"]),
              "layer_index": _i(grp["layer_index"]),
              "rama_residue": _i(grp["rama_residue"])}
    for extra in ("beadtype_seq", "id_seq"):
        if extra in grp:
            consts[extra] = np.asarray(grp[extra])
    data = _a(grp["placement_data"]).astype(np.float64)
    return consts, make_rama_placement_params(data)


def _read_weighted_pos(grp):
    return ({"index_pos": _i(grp["index_pos"]),
             "index_weight": _i(grp["index_weight"])}, {})


def _read_uniform_transform(grp):
    ds = grp["bspline_coeff"]
    return ({}, {"bspline_coeff": _a(ds),
                 "spline_offset": np.float32(ds.attrs["spline_offset"]),
                 "spline_inv_dx": np.float32(ds.attrs["spline_inv_dx"])})


def _read_linear_coupling(grp):
    consts = {"coupling_types": _i(grp["coupling_types"])}
    if "inactivation_dim" in grp.attrs:
        consts["inactivation_dim"] = int(grp.attrs["inactivation_dim"])
    return consts, {"couplings": _a(grp["couplings"])}


def _read_nonlinear_coupling(grp):
    ds = grp["coeff"]
    return ({"coupling_types": _i(grp["coupling_types"]),
             "spline_offset": float(ds.attrs["spline_offset"]),
             "spline_inv_dx": float(ds.attrs["spline_inv_dx"])},
            {"coeff": _a(ds)})


def _read_rotamer(grp):
    pg = grp["pair_interaction"]
    consts = make_rotamer_consts(
        np.asarray(pg["id"]), _i(pg["index"]), _i(pg["type"]),
        damping=float(grp.attrs["damping"]),
        max_iter=int(grp.attrs["max_iter"]),
        tol=float(grp.attrs["tol"]))
    consts["iteration_chunk_size"] = int(
        grp.attrs.get("iteration_chunk_size", 1))
    return consts, {"interaction_param": _a(pg["interaction_param"])}


def _read_membrane(grp):
    cb = grp["cb_energy"]
    uhb = grp["uhb_energy"]
    cb_z_min, cb_z_max = float(cb.attrs["z_min"]), float(cb.attrs["z_max"])
    uhb_z_min = float(uhb.attrs["z_min"])
    uhb_z_max = float(uhb.attrs["z_max"])
    nx_cb = cb.shape[1]
    nx_uhb = uhb.shape[1]
    consts = {
        "cb_index": _i(grp["cb_index"]),
        "env_index": _i(grp["env_index"]),
        "residue_type": _i(grp["residue_type"]),
        "cov_midpoint": _a(grp["cov_midpoint"]),
        "cov_sharpness": _a(grp["cov_sharpness"]),
        "cb_z_shift": -cb_z_min,
        "cb_z_scale": (nx_cb - 1) / (cb_z_max - cb_z_min),
        "uhb_z_shift": -uhb_z_min,
        "uhb_z_scale": (nx_uhb - 1) / (uhb_z_max - uhb_z_min),
        "n_donor": _i(grp["donor_residue_ids"]).shape[0],
    }
    params = make_membrane_params(_a(cb).astype(np.float64),
                                  _a(uhb).astype(np.float64))
    return consts, params


def _read_constant(grp):
    return ({}, {"value": _a(grp["value"])})


def _read_slice(grp):
    return ({"id": _i(grp["id"])}, {})


def _read_concat(grp):
    return ({}, {})


def _read_fixed_hmm(grp):
    return ({"index": _i(grp["index"])},
            {"transition_energy": _a(grp["transition_energy"])})


def _read_torus_dbn(grp):
    return ({"id": _i(grp["id"]), "restypes": _i(grp["restypes"]),
             "basin_param": _a(grp["basin_param"])},
            {"prior_offset_energies": _a(grp["prior_offset_energies"])})


def _read_backbone_featurizer(grp):
    hb = _i(grp["hbond_idx"])
    return ({"rama_idx": _i(grp["rama_idx"]),
             "donor_idx": hb[:, 0], "acceptor_idx": hb[:, 1]}, {})


def _read_conv1d(grp):
    act = grp.attrs["activation"]
    if isinstance(act, (list, np.ndarray)):
        act = act[0]
    if isinstance(act, bytes):
        act = act.decode()
    return ({"activation": str(act)},
            {"weights": _a(grp["weights"]), "bias": _a(grp["bias"])})


def _read_scaled_sum(grp):
    return ({"scale": float(grp.attrs["scale"])}, {})


READERS = {
    "atom_pos_spring": _read_pos_spring,
    "tension": _read_tension,
    "AFM": _read_afm,
    "dist_spring": _read_dist_spring,
    "angle_spring": _read_angle_spring,
    "dihedral_spring": _read_dihedral_spring,
    "cavity_radial": _read_cavity_radial,
    "z_flat_bottom": _read_z_flat_bottom,
    "rama_coord": _read_rama_coord,
    "rama_map_pot": _read_rama_map_pot,
    "affine_alignment": _read_affine_alignment,
    "backbone_pairs": _read_backbone_pairs,
    "infer_H_O": _read_infer_h_o,
    "protein_hbond": _read_protein_hbond,
    "hbond_energy": _read_hbond_energy,
    "hbond_coverage": _read_protein_hbond,
    "hbond_sc_radial": _read_protein_hbond,
    "environment_coverage": _read_protein_hbond,
    "radial": _read_radial,
    "contact": _read_contact,
    "placement_scalar": _read_placement_rama,
    "placement_fixed_scalar": _read_placement_fixed,
    "placement_point_only": _read_placement_rama,
    "placement_fixed_point_only": _read_placement_fixed,
    "placement_point_vector_only": _read_placement_rama,
    "placement_fixed_point_vector_only": _read_placement_fixed,
    "placement_fixed_point_vector_scalar": _read_placement_fixed,
    "weighted_pos": _read_weighted_pos,
    "uniform_transform": _read_uniform_transform,
    "linear_coupling_uniform": _read_linear_coupling,
    "linear_coupling_with_inactivation": _read_linear_coupling,
    "nonlinear_coupling": _read_nonlinear_coupling,
    "rotamer": _read_rotamer,
    "membrane_potential": _read_membrane,
    "constant": _read_constant,
    "slice": _read_slice,
    "concat": _read_concat,
    "fixed_hmm": _read_fixed_hmm,
    "torus_dbn": _read_torus_dbn,
    "backbone_featurizer": _read_backbone_featurizer,
    "conv1d": _read_conv1d,
    "scaled_sum": _read_scaled_sum,
}


def read_node(name, grp):
    nt = resolve_node_type(name)
    reader = READERS[nt.name]
    consts, params = reader(grp)
    return NodeSpec(name=name, node_type=nt, args=_args(grp),
                    consts=consts, params=params)


def load_system(source):
    """Load a system from a `.up` file path, or from the in-memory Group
    that ConfigBuilder.to_group returns (no h5py needed).  Returns
    (System, params, initial_pos, aux)."""
    if isinstance(source, Group):
        return _load(source)
    import h5py
    with h5py.File(source, "r") as f:
        return _load(f)


def _load(f):
    aux: Dict = {}
    pot = f["input/potential"]
    # sorted: the order h5py iterates a group in, for both sources
    specs = [read_node(name, pot[name]) for name in sorted(pot)]
    pos_ds = np.asarray(f["input/pos"])
    if pos_ds.ndim == 3:
        pos_ds = pos_ds[:, :, 0]
    n_atom = pos_ds.shape[0]

    if "input/sequence" in f:
        aux["sequence"] = [s.decode() if isinstance(s, bytes) else str(s)
                           for s in np.asarray(f["input/sequence"])]
    for mv in ("pivot_moves", "jump_moves"):
        if f"input/{mv}" in f:
            g = f[f"input/{mv}"]
            aux[mv] = {k: np.asarray(g[k]) for k in g}
    if "input/chain_break" in f:
        g = f["input/chain_break"]
        aux["chain_break"] = {k: np.asarray(g[k]) for k in g}

    system = System(n_atom, specs)
    return system, system.make_params(), pos_ds.astype(np.float32), aux
