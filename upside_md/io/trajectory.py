"""Trajectory reading, virtual-atom reconstruction, and export.

Functional replacement for py/mdtraj_upside.py and py/extract_vtf.py:
* stitch /output with the /output_previous_* resume chain
* reconstruct virtual amide H, carbonyl O, and CB positions from the
  3-atom backbone (same geometry as the reference, mdtraj_upside.py:28-109)
* demux replica-exchange trajectories by replica index
* export multi-model PDB and VMD-readable VTF without external packages;
  an mdtraj Trajectory is produced when mdtraj is importable.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

H_BOND_LENGTH = 0.88
O_BOND_LENGTH = 1.24
CB_EXTEND = 0.94375626
CB_CROSS = 0.5796686718421049


def _vhat(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def output_groups(h5file):
    """Yield output groups oldest-first (the output_previous_* chain,
    mdtraj_upside.py:19-26)."""
    i = 0
    groups = []
    while f"output_previous_{i}" in h5file:
        groups.append(h5file[f"output_previous_{i}"])
        i += 1
    if "output" in h5file:
        groups.append(h5file["output"])
    return groups


def load_upside_traj(path, stride=1, include_previous=True):
    """Returns (seq (3-letter list), time (n_frame,), pos (n_frame, n_atom, 3))."""
    import h5py
    with h5py.File(path, "r") as f:
        seq = [s.decode() if isinstance(s, bytes) else str(s)
               for s in f["input/sequence"]]
        groups = output_groups(f) if include_previous else [f["output"]]
        xyz, time = [], []
        for g in groups:
            p = np.asarray(g["pos"])
            xyz.append(p[:, 0] if p.ndim == 4 else p)
            if "time" in g:
                time.append(np.asarray(g["time"]).reshape(-1))
            else:
                time.append(np.arange(len(p), dtype=np.float64))
        pos = np.concatenate(xyz)[::stride]
        time = np.concatenate(time)[::stride]
    return seq, time, pos


def load_upside_rep(paths, stride=1):
    """Demultiplex replica-exchange runs: returns per-replica trajectories
    gathered across the swapping slot files (mdtraj_upside.py:155-203)."""
    import h5py
    slots = []
    indices = []
    for path in paths:
        seq, time, pos = load_upside_traj(path, stride)
        slots.append(pos)
        with h5py.File(path, "r") as f:
            gs = output_groups(f)
            idx = np.concatenate([np.asarray(g["replica_index"]).reshape(
                len(g["pos"]), -1)[:, 0] for g in gs])[::stride]
        indices.append(idx)
    slots = np.stack(slots)      # (n_slot, n_frame, n_atom, 3)
    indices = np.stack(indices)  # (n_slot, n_frame)
    n_rep, n_frame = slots.shape[0], slots.shape[1]
    demux = np.empty_like(slots)
    for fr in range(n_frame):
        order = np.argsort(indices[:, fr])
        demux[:, fr] = slots[order, fr]
    return seq, time, demux


def reconstruct_virtual_atoms(seq, pos, chain_first_residue=(0,)):
    """Expand backbone N/CA/C frames with NH, CB, O virtual atoms.

    pos: (n_frame, 3*n_res, 3).  Returns (atom_names, atom_residues, xyz
    (n_frame, n_expanded, 3)) with the reference's geometry rules."""
    n_frame = pos.shape[0]
    n_res = len(seq)
    seq = ['PRO' if s == 'CPR' else s for s in seq]
    first = set(chain_first_residue) | {0}

    names: List[str] = []
    residues: List[int] = []
    cols = []
    for nr in range(n_res):
        N = pos[:, 3 * nr + 0]
        CA = pos[:, 3 * nr + 1]
        C = pos[:, 3 * nr + 2]
        for nm, x in (('N', N), ('CA', CA), ('C', C)):
            names.append(nm)
            residues.append(nr)
            cols.append(x[:, None])
        if nr not in first and seq[nr] != 'PRO':
            lastC = pos[:, 3 * nr - 1]
            H = N - H_BOND_LENGTH * _vhat(_vhat(lastC - N) + _vhat(CA - N))
            names.append('H'); residues.append(nr); cols.append(H[:, None])
        if seq[nr] != 'GLY':
            extend = _vhat(_vhat(CA - N) + _vhat(CA - C))
            cross = np.cross(N - CA, C - CA)
            CB = CA + CB_EXTEND * extend + CB_CROSS * cross
            names.append('CB'); residues.append(nr); cols.append(CB[:, None])
        if nr + 1 < n_res and (nr + 1) not in first:
            nextN = pos[:, 3 * nr + 3]
            O = C - O_BOND_LENGTH * _vhat(_vhat(CA - C) + _vhat(nextN - C))
            names.append('O'); residues.append(nr); cols.append(O[:, None])
    xyz = np.concatenate(cols, axis=1)
    return names, residues, xyz


def to_mdtraj(seq, time, pos, chain_first_residue=(0,)):
    """Build an mdtraj Trajectory (requires mdtraj; nanometer units)."""
    import mdtraj as md
    from mdtraj.core import element as el

    names, residues, xyz = reconstruct_virtual_atoms(
        seq, pos, chain_first_residue)
    topo = md.Topology()
    seq3 = ['PRO' if s == 'CPR' else s for s in seq]
    res_objs = []
    chain = None
    for nr, s in enumerate(seq3):
        if nr in set(chain_first_residue) | {0}:
            chain = topo.add_chain()
        res_objs.append(topo.add_residue(s, chain, resSeq=nr))
    elements = {'N': el.nitrogen, 'CA': el.carbon, 'C': el.carbon,
                'H': el.hydrogen, 'CB': el.carbon, 'O': el.oxygen}
    for nm, nr in zip(names, residues):
        topo.add_atom(nm, elements[nm], res_objs[nr])
    return md.Trajectory(xyz=xyz * 0.1, topology=topo, time=time)


def write_vtf(path, seq, pos, chain_first_residue=(0,)):
    """VMD-readable VTF trajectory with inferred H/O/CB
    (reference: py/extract_vtf.py)."""
    names, residues, xyz = reconstruct_virtual_atoms(
        seq, pos, chain_first_residue)
    seq3 = ['PRO' if s == 'CPR' else s for s in seq]
    with open(path, 'w') as f:
        for i, (nm, nr) in enumerate(zip(names, residues)):
            f.write(f"atom {i} name {nm} resname {seq3[nr]} resid {nr}\n")
        prev = None
        for i, (nm, nr) in enumerate(zip(names, residues)):
            if nm == 'CA':
                f.write(f"bond {i - 1}:{i}\n")
            elif nm == 'C':
                # CA index just before C (may be separated by nothing)
                f.write(f"bond {i - 1}:{i}\n")
            elif nm in ('CB', 'H', 'O'):
                # bond to its CA/N/C anchor
                anchor = {'CB': 'CA', 'H': 'N', 'O': 'C'}[nm]
                for j in range(i - 1, -1, -1):
                    if residues[j] == nr and names[j] == anchor:
                        f.write(f"bond {j}:{i}\n")
                        break
        first = set(chain_first_residue) | {0}
        # peptide bonds C(i)-N(i+1)
        for nr in range(len(seq3) - 1):
            if (nr + 1) in first:
                continue
            ci = [j for j in range(len(names))
                  if residues[j] == nr and names[j] == 'C'][0]
            nj = [j for j in range(len(names))
                  if residues[j] == nr + 1 and names[j] == 'N'][0]
            f.write(f"bond {ci}:{nj}\n")
        for frame in xyz:
            f.write("timestep ordered\n")
            for x in frame:
                f.write(f"{x[0]:.3f} {x[1]:.3f} {x[2]:.3f}\n")


def write_pdb(path, seq, pos, model_stride=1):
    """Multi-model backbone PDB (no external deps)."""
    seq3 = ['PRO' if s == 'CPR' else s for s in seq]
    with open(path, 'w') as f:
        for m, frame in enumerate(pos[::model_stride]):
            f.write(f"MODEL     {m + 1:4d}\n")
            serial = 1
            for nr, s in enumerate(seq3):
                for nm, x in zip(('N', 'CA', 'C'), frame[3 * nr:3 * nr + 3]):
                    f.write(f"ATOM  {serial:5d} {nm:^4s}{s:>4s} A"
                            f"{nr + 1:4d}    {x[0]:8.3f}{x[1]:8.3f}"
                            f"{x[2]:8.3f}  1.00  0.00\n")
                    serial += 1
            f.write("ENDMDL\n")
        f.write("END\n")
