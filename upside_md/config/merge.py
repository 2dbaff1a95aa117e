"""Merge per-chain configs into one multichain system with separate
interaction graphs (reference: py/multi_igraph.py).

Each chain's potential groups are copied with a `_<i>` suffix and rewired:
`pos` arguments become per-chain `slice_<i>` nodes selecting that chain's
atoms.  The combined file's own groups (cavity_radial, pivot/jump moves,
chain_break) are taken from the base file.  Prefix-based node-type
resolution makes the suffixed names resolve to the same node types.
"""

from __future__ import annotations

from typing import List

import numpy as np

SHARED_GROUPS = {"cavity_radial"}


def _copy_group(src, dst_parent, name):
    src.file.copy(src, dst_parent, name=name)


def merge_configs(base_path: str, chain_paths: List[str], out_path: str):
    """base_path: combined-system config (all chains' pos/sequence, cavity,
    chain breaks, samplers); chain_paths: per-chain configs whose potential
    graphs are kept separate."""
    import h5py
    with h5py.File(out_path, "w") as out:
        with h5py.File(base_path, "r") as base:
            base.copy(base["input"], out, name="input")
        pot = out["input/potential"]
        # drop the base potential groups that will be replaced per chain
        for name in list(pot.keys()):
            if name not in SHARED_GROUPS:
                del pot[name]

        atom_offset = 0
        for ci, path in enumerate(chain_paths):
            with h5py.File(path, "r") as cin:
                n_res = len(cin["input/sequence"])
                n_atom = 3 * n_res
                # slice node selecting this chain's atoms from global pos
                sg = pot.create_group(f"slice_{ci}")
                sg.attrs["arguments"] = np.asarray(["pos"], dtype="S")
                sg.create_dataset(
                    "id", data=np.arange(atom_offset, atom_offset + n_atom))
                for name, grp in cin["input/potential"].items():
                    if name in SHARED_GROUPS:
                        continue
                    new_name = f"{name}_{ci}"
                    cin.copy(grp, pot, name=new_name)
                    args = [a.decode() if isinstance(a, bytes) else str(a)
                            for a in pot[new_name].attrs["arguments"]]
                    new_args = [f"slice_{ci}" if a == "pos" else f"{a}_{ci}"
                                for a in args]
                    pot[new_name].attrs["arguments"] = np.asarray(new_args,
                                                                  dtype="S")
                atom_offset += n_atom
    return out_path
