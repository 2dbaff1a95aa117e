"""Benchmark: aggregate MD steps/sec for batched 76-residue ubiquitin
full-forcefield replicas on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "steps/s", "device": {...}, ...}

A "step" is one force evaluation (the reference reports us/system/step with
3 steps per integration round, src/main.cpp:677-682).  The forcefield is
built from the reference parameter libraries when UPSIDE_PARAM_DIR names
them, and otherwise from the seeded libraries (bench_systems); the record
says which.  Exits non-zero without a GPU.

Environment: BENCH_REPLICAS (default 64), BENCH_ROUNDS (default 20),
BENCH_SEED.
"""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from upside_md.bench_systems import (UBIQUITIN, build_full_system,  # noqa: E402
                                     have_reference_params)
from upside_md.compile_cache import enable_compile_cache  # noqa: E402
from upside_md.md.sim import Simulation  # noqa: E402
from upside_md.nodes.rotamer import bp_solve_health  # noqa: E402


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX runs on {dev.platform})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.splitlines()[0].strip()
    enable_compile_cache()

    n_replica = int(os.environ.get("BENCH_REPLICAS", "64"))
    n_rounds = int(os.environ.get("BENCH_ROUNDS", "20"))
    seed = int(os.environ.get("BENCH_SEED", "1"))
    params_label = ("reference parameters" if have_reference_params()
                    else "seeded parameters")

    system, params, pos, aux = build_full_system(seq=UBIQUITIN)
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     do_recenter=False)
    state = sim.initial_state(pos, params, seed=seed, temperature=0.85,
                              n_replica=n_replica)

    # compile + warm up with the same static round count as the measured
    # calls, so exactly one executable is built
    t0 = time.perf_counter()
    state = jax.block_until_ready(sim.advance(state, params, n_rounds, True))
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state = jax.block_until_ready(
            sim.advance(state, params, n_rounds, True))
        times.append(time.perf_counter() - t0)
    elapsed = sorted(times)[len(times) // 2]
    steps = 3 * n_rounds * n_replica  # force evaluations across the ensemble
    if not np.all(np.isfinite(np.asarray(state.pos))):
        sys.exit("bench.py: non-finite positions")

    record = {
        "metric": f"aggregate MD steps/sec, 76-res ubiquitin full FF "
                  f"({params_label}), {n_replica} replicas",
        "value": round(steps / elapsed, 1),
        "unit": "steps/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "compile_and_first_call_s": round(compile_s, 2),
        "peak_bytes_in_use": (dev.memory_stats() or {}).get(
            "peak_bytes_in_use"),
    }
    rot_specs = {s.name: s for s in system.specs
                 if s.node_type.name == "rotamer"}
    for name, entry in (state.cache or {}).items():
        if name in rot_specs:
            deviation, sweeps = bp_solve_health(entry)
            tol = float(rot_specs[name].consts["tol"])
            record["bp_sweeps_mean"] = round(float(sweeps.mean()), 2)
            record["bp_n_bad_solve"] = int((deviation > tol).sum())
    print(json.dumps(record))


if __name__ == "__main__":
    main()
