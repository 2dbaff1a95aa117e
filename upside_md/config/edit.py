"""Post-hoc editing of compiled `.up` configs.

Equivalents of the reference's in-place config editors:

* ``break_chains`` — convert an already-compiled single-chain config
  into a multichain system: record chain starts, add rigid-jump MC
  moves, cut bonded spring terms that span a chain boundary, and mark
  boundary-crossing phi/psi angles as dummies
  (reference: py/ugly_hack_break_chain.py:7-160).
* ``add_target_information`` — attach a target structure under
  ``/target/pos`` for restraint or analysis use
  (reference: py/add_target_information.py:8-24).

Both operate on files written either by :class:`..config.builder.ConfigBuilder`
or by the reference's own config compiler (the dataset names are shared).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np


def find_multichain_terms(ids: np.ndarray,
                          chain_starts: np.ndarray) -> np.ndarray:
    """Rows of an (n_term, k) atom-id table whose atoms span >1 chain.

    ``chain_starts`` are first-*atom* indices of every chain (including 0).
    Reference semantics: ugly_hack_break_chain.py:7-13.
    """
    ids = np.asarray(ids)
    chain_starts = np.asarray(chain_starts, dtype=np.int64)
    chain_num = (ids[:, :, None] >= chain_starts[None, None, :]).sum(-1)
    return chain_num.max(1) != chain_num.min(1)


def _cut_rows(grp: h5py.Group, names: Sequence[str],
              remove: np.ndarray) -> int:
    """Delete the flagged rows from each named dataset of a group
    (fixed-shape h5py datasets have no truncate, so rewrite)."""
    import h5py
    keep = ~remove
    for nm in names:
        data = np.asarray(grp[nm])[keep]
        attrs = dict(grp[nm].attrs)
        del grp[nm]
        ds = grp.create_dataset(nm, data=data)
        for k, v in attrs.items():
            ds.attrs[k] = v
    return int(remove.sum())


def break_chains(path: str, chain_first_residue: Sequence[int],
                 rl_chains: Optional[Sequence[int]] = None,
                 jump_length_scale: float = 5.0,
                 jump_rotation_scale: float = 30.0,
                 remove_pivot: bool = False,
                 verbose: bool = False):
    """In-place multichain conversion of a compiled config.

    ``chain_first_residue`` lists the first residue of every chain after
    the first (residue 0 is implied), matching
    ``ConfigBuilder.add_chain_breaks``.  Cuts ``angle_spring`` /
    ``dihedral_spring`` rows and *bonded* ``dist_spring`` rows whose atoms
    span chains, converts boundary-crossing ``rama_coord`` rows to dummy
    phi/psi, and installs ``/input/chain_break`` + ``/input/jump_moves``.
    Reference: ugly_hack_break_chain.py:103-158.
    """
    import h5py
    chain_first_residue = [int(x) for x in chain_first_residue]
    if not chain_first_residue:
        raise ValueError("need at least one chain break residue")

    with h5py.File(path, "a") as f:
        inp = f["input"]
        pot = inp["potential"]
        n_res = len(inp["sequence"])
        starts = np.array([0] + chain_first_residue, dtype=np.int64) * 3
        ends = np.append(starts, 3 * n_res)
        n_chain = len(starts)

        if "chain_break" in inp:
            del inp["chain_break"]
        cb = inp.create_group("chain_break")
        cb.create_dataset("chain_first_residue",
                          data=np.asarray(chain_first_residue, np.int32))
        if rl_chains is not None:
            rl_chains = np.asarray(rl_chains, np.int32)
            if rl_chains.sum() != n_chain:
                raise ValueError(
                    f"rl_chains {rl_chains.tolist()} must sum to the "
                    f"number of chains ({n_chain})")
            cb.create_dataset("rl_chains", data=rl_chains)

        # rigid-jump MC moves: one range per chain, or receptor/ligand
        # collective ranges (reference :105-116)
        if rl_chains is None:
            atom_range = np.stack([ends[:-1], ends[1:]], axis=1)
        else:
            atom_range = np.array(
                [[ends[0], ends[rl_chains[0]]],
                 [ends[rl_chains[0]], ends[-1]]])
        if "jump_moves" in inp:
            del inp["jump_moves"]
        jm = inp.create_group("jump_moves")
        jm.create_dataset("atom_range", data=atom_range.astype(np.int32))
        jm.create_dataset("sigma_trans", data=np.full(
            len(atom_range), jump_length_scale, np.float32))
        jm.create_dataset("sigma_rot", data=np.full(
            len(atom_range), jump_rotation_scale * np.pi / 180.0, np.float32))
        if remove_pivot and "pivot_moves" in inp:
            del inp["pivot_moves"]

        # cut bonded terms spanning chains (reference :127-129)
        for name, fields, consider in (
                ("angle_spring", ("equil_dist", "spring_const"), None),
                ("dihedral_spring", ("equil_dist", "spring_const"), None),
                ("dist_spring", ("equil_dist", "spring_const",
                                 "bonded_atoms"), "bonded_atoms")):
            if name not in pot:
                continue
            grp = pot[name]
            bad = find_multichain_terms(np.asarray(grp["id"]), starts)
            if consider is not None:
                bad &= np.asarray(grp[consider]).astype(bool)
            n = _cut_rows(grp, ("id",) + fields, bad)
            if verbose and n:
                print(f"cut {n} multichain rows from {name}")

        # hbond donors/acceptors cannot be cut post hoc (reference :131-141)
        if "infer_H_O" in pot:
            g = pot["infer_H_O"]
            for sub in ("donors", "acceptors"):
                if sub in g and find_multichain_terms(
                        np.asarray(g[sub]["id"]), starts).any():
                    raise ValueError(
                        "infer_H_O spans a chain break; rebuild the config "
                        "with hbond_excluded_residues instead of editing")

        # boundary-crossing phi/psi become dummy angles (reference :143-157)
        if "rama_coord" in pot:
            tbl = np.asarray(pot["rama_coord"]["id"])
            locs = np.nonzero(find_multichain_terms(tbl, starts))[0]
            for loc in locs:
                chain_num = (tbl[loc][:, None] >= starts).sum(-1)
                if not (chain_num[1] == chain_num[2] == chain_num[3]
                        and (chain_num[0] == chain_num[1]
                             or chain_num[3] == chain_num[4])):
                    raise ValueError(
                        f"rama_coord row {loc} spans a chain break in an "
                        "unsupported pattern")
                if chain_num[0] == chain_num[1]:
                    tbl[loc, 4] = -1   # cut psi
                else:
                    tbl[loc, 0] = -1   # cut phi
            if len(locs):
                pot["rama_coord"]["id"][...] = tbl
                if verbose:
                    print(f"dummied {len(locs)} rama_coord rows")
    return path


def add_target_information(path: str, target_pos: np.ndarray,
                           replace: bool = False):
    """Write a target structure to ``/target/pos`` of an existing config
    (reference: add_target_information.py:8-24)."""
    import h5py
    target_pos = np.asarray(target_pos, np.float32)
    if target_pos.ndim == 3:
        target_pos = target_pos[:, :, 0]
    with h5py.File(path, "a") as f:
        pos = np.asarray(f["input/pos"])
        if pos.ndim == 3:
            pos = pos[:, :, 0]
        if target_pos.shape != pos.shape:
            raise ValueError(
                f"target shape {target_pos.shape} != system {pos.shape}")
        if "target" in f:
            if not replace:
                raise ValueError("config already has /target "
                                 "(pass replace=True)")
            del f["target"]
        f.create_group("target").create_dataset("pos", data=target_pos)
    return path


def main(argv=None):
    import h5py
    p = argparse.ArgumentParser(
        description="Post-hoc editing of compiled .up configs")
    sub = p.add_subparsers(dest="cmd", required=True)

    bc = sub.add_parser("break-chains",
                        help="convert a config to multichain in place")
    bc.add_argument("config")
    bc.add_argument("--chain-first-residue", type=int, action="append",
                    default=[], help="first residue of each chain after "
                    "the first; repeatable")
    bc.add_argument("--chain-break-from-file", action="store_true",
                    help="reuse breaks already recorded in the config")
    bc.add_argument("--rl-chains", nargs=2, type=int, default=None,
                    help="receptor/ligand chain counts for collective jumps")
    bc.add_argument("--jump-length-scale", type=float, default=5.0)
    bc.add_argument("--jump-rotation-scale", type=float, default=30.0)
    bc.add_argument("--remove-pivot", action="store_true")

    at = sub.add_parser("add-target",
                        help="attach a target structure under /target")
    at.add_argument("config")
    at.add_argument("--target-structure", required=True,
                    help=".npy (n_atom,3) or .initial.pkl structure")
    at.add_argument("--replace", action="store_true")

    args = p.parse_args(argv)
    if args.cmd == "break-chains":
        breaks = list(args.chain_first_residue)
        if args.chain_break_from_file:
            with h5py.File(args.config, "r") as f:
                if "input/chain_break/chain_first_residue" not in f:
                    sys.exit("--chain-break-from-file: config records "
                             "no chain breaks")
                breaks = np.asarray(
                    f["input/chain_break/chain_first_residue"]).tolist()
        break_chains(args.config, breaks, rl_chains=args.rl_chains,
                     jump_length_scale=args.jump_length_scale,
                     jump_rotation_scale=args.jump_rotation_scale,
                     remove_pivot=args.remove_pivot, verbose=True)
    elif args.cmd == "add-target":
        if args.target_structure.endswith(".npy"):
            pos = np.load(args.target_structure)
        else:
            import pickle
            with open(args.target_structure, "rb") as fh:
                pos = pickle.load(fh)
        add_target_information(args.config, pos, replace=args.replace)


if __name__ == "__main__":
    main()
