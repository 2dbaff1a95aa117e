"""Job orchestration (reference: py/run_upside.py).

Config + simulation launch helpers, continuation of interrupted runs, and
replica-ladder swap-set generation.  Where the reference shells out to the
`upside` binary (locally or via srun/sbatch), this drives the in-process
CLI; `continue_sim` reproduces the /output -> /output_previous_i rename +
position reseed semantics (run_upside.py:231-254).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from typing import List, Optional

import numpy as np


def upside_config(fasta, output_path, initial_structure=None,
                  rama_maps=None, rama_library=None, sheet_mixing=None,
                  hbond_energy=0.0, backbone=True,
                  rotamer_placement=None, rotamer_interaction=None,
                  dynamic_rotamer_1body=True, rotamer_damping=0.4,
                  environment_potential=None, cavity_radius=0.0,
                  fix_rotamer=None, seed=0):
    """Programmatic equivalent of the upside_config.py CLI: assemble a
    `.up` file from a FASTA plus parameter libraries."""
    from .config.builder import ConfigBuilder

    init = None
    if initial_structure is not None:
        if isinstance(initial_structure, (str, os.PathLike)):
            init = pickle.load(open(initial_structure, 'rb'),
                               encoding='latin1')
            init = np.asarray(init)[..., 0] if init.ndim == 3 else init
        else:
            init = np.asarray(initial_structure)

    b = ConfigBuilder(fasta if fasta.startswith('>') else open(fasta).read(),
                      initial_pos=init, seed=seed)
    b.add_backbone_springs()
    if rama_library:
        b.add_rama_map_pot_from_library(rama_library, sheet_mixing)
    elif rama_maps is not None:
        b.add_rama_map_pot(rama_maps)
    if rotamer_placement and rotamer_interaction:
        b.add_rotamer_sidechains(rotamer_placement, rotamer_interaction,
                                 damping=rotamer_damping,
                                 dynamic_1body=dynamic_rotamer_1body,
                                 fix_rotamer=fix_rotamer)
    if hbond_energy:
        b.add_hbond(hbond_energy=hbond_energy,
                    coverage_library=rotamer_interaction)
    if environment_potential:
        b.add_environment(environment_potential)
    if rotamer_placement and rotamer_interaction:
        b.add_rotamer_node()
    if backbone:
        b.add_backbone_pairs()
    if cavity_radius:
        b.add_cavity_radial(cavity_radius)
    return b.write(output_path)


def run_upside(config_paths: List[str], duration, frame_interval,
               temperature="1.0", extra_args: Optional[List[str]] = None,
               in_process=True, **kw):
    """Launch a simulation over one or more configs.

    in_process=True calls the CLI main() directly (the reference's
    `in_process_upside`, upside_engine.py:67-91); otherwise a subprocess
    is spawned so cluster wrappers can manage it.  With in_process=False
    the calling process must not have used the GPU through JAX first: a
    JAX process reserves most of the card's memory when it first touches
    it, so the child would fail for want of memory."""
    args = [f"--duration={duration}", f"--frame-interval={frame_interval}",
            f"--temperature={temperature}"]
    for k, v in kw.items():
        flag = "--" + k.replace('_', '-')
        if v is True:
            args.append(flag)
        elif v is not False and v is not None:
            args.append(f"{flag}={v}")
    args += list(extra_args or [])
    args += list(config_paths)
    if in_process:
        from .cli import main
        return main(args)
    return subprocess.call([sys.executable, "-m", "upside_md.cli"] + args)


def continue_sim(config_paths: List[str], duration, frame_interval, **kw):
    """Continue interrupted runs: move /output to /output_previous_i and
    reseed /input/pos from the last frame (run_upside.py:231-254), then
    relaunch."""
    import h5py
    for path in config_paths:
        with h5py.File(path, 'a') as t:
            i = 0
            while f'output_previous_{i}' in t:
                i += 1
            if 'output' in t:
                t.move('output', f'output_previous_{i}')
                last_frame = np.asarray(t[f'output_previous_{i}/pos'])[-1]
                if last_frame.ndim == 3:  # (1, n_atom, 3)
                    last_frame = last_frame[0]
                t['input/pos'][...] = last_frame[:, :, None]
    return run_upside(config_paths, duration, frame_interval, **kw)


def swap_table2d(nx, ny):
    """Swap sets for a 2D replica ladder (run_upside.py:395-405): four sets
    of non-overlapping neighbor swaps (even/odd in each direction)."""
    idx = lambda x, y: x * ny + y  # noqa: E731
    sets = []
    for parity in (0, 1):
        s = [f"{idx(x, y)}-{idx(x + 1, y)}"
             for x in range(parity, nx - 1, 2) for y in range(ny)]
        if s:
            sets.append(','.join(s))
    for parity in (0, 1):
        s = [f"{idx(x, y)}-{idx(x, y + 1)}"
             for x in range(nx) for y in range(parity, ny - 1, 2)]
        if s:
            sets.append(','.join(s))
    return sets
