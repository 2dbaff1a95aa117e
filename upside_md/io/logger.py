"""Trajectory/output logging into the `.up` file's /output group.

Matches the reference H5Logger conventions (src/state_logger.h): extensible
datasets appended one row per frame, `pos` stored as (n_frame, 1, n_atom, 3)
so existing readers (py/mdtraj_upside.py:133 `g.pos[sl,0]`) work unchanged.
Writes land after device->host transfer at frame boundaries only — the MD
inner loop never synchronizes.  Resume renames /output -> /output_previous_i
like run_upside.continue_sim (py/run_upside.py:231-254).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

LOG_LEVELS = ("basic", "detailed", "extensive")


class H5Logger:
    def __init__(self, path, level="detailed", buffer_frames=100,
                 invocation=""):
        import h5py
        self.path = path
        self.level = level
        self.buffer_frames = buffer_frames
        self._buffers: Dict[str, list] = {}
        self._file = h5py.File(path, "a")
        if "output" in self._file:
            # continue_sim semantics: shift the previous run's output
            i = 0
            while f"output_previous_{i}" in self._file:
                i += 1
            self._file.move("output", f"output_previous_{i}")
        self._out = self._file.create_group("output")
        if invocation:
            self._out.attrs["invocation"] = invocation

    def log_frame(self, name, value):
        value = np.asarray(value)
        self._buffers.setdefault(name, []).append(value)
        if len(self._buffers[name]) >= self.buffer_frames:
            self._flush_one(name)

    def log_once(self, name, value):
        self._out.create_dataset(name, data=np.asarray(value))

    def _flush_one(self, name):
        rows = self._buffers.pop(name, [])
        if not rows:
            return
        block = np.stack(rows)
        if name not in self._out:
            self._out.create_dataset(
                name, data=block, maxshape=(None,) + block.shape[1:],
                chunks=True)
        else:
            ds = self._out[name]
            n0 = ds.shape[0]
            ds.resize(n0 + block.shape[0], axis=0)
            ds[n0:] = block
        self._file.flush()

    def flush(self):
        for name in list(self._buffers):
            self._flush_one(name)

    def close(self):
        self.flush()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def log_standard_frame(logger: H5Logger, sim, state, params, batched=False,
                       replica_index=None):
    """The standard per-frame streams (main.cpp:526-541): pos (1,n_atom,3),
    kinetic, potential, time, temperature."""
    pos = np.asarray(state.pos)
    mom = np.asarray(state.mom)
    if batched:
        # one logger per replica file is the reference layout; a batched
        # logger stores the replica axis explicitly
        logger.log_frame("pos", pos[:, None])
        logger.log_frame("kinetic",
                         0.5 * (mom ** 2).sum(-1).mean(-1)[:, None])
    else:
        logger.log_frame("pos", pos[None])
        logger.log_frame("kinetic",
                         np.array([0.5 * (mom ** 2).sum(-1).mean()]))
    pot = np.asarray(sim.potential_energy(state, params, batched))
    logger.log_frame("potential", pot.reshape(-1, 1) if batched
                     else np.array([pot]))
    rn = np.asarray(state.round_num).reshape(-1)[0]
    logger.log_frame("time", np.asarray(3.0 * sim.dt * float(rn)))
    temp = np.asarray(state.temperature)
    logger.log_frame("temperature", temp.reshape(-1, 1) if batched
                     else np.array([temp]))
    if replica_index is not None:
        logger.log_frame("replica_index", np.asarray(replica_index))
