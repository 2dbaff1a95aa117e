"""Profile one window of the flagship MD advance on the GPU and reduce the
device trace to time shares.

Builds the seeded full-forcefield ubiquitin (as chip_smoke.py does), warms
up `Simulation.advance` at 64 replicas, traces one 20-round call with
jax.profiler, and reports, over that call's host window:
  - the device idle share (1 - union of kernel intervals / window);
  - the share of device time in the BP solve (kernels whose HLO op_name
    lies under the `bp_solve` named scope, nodes/rotamer.py);
  - the share in the pair splines (`pair_spline` scope, ops/pairs.py);
  - the share in cuBLAS matrix products (the one-hot gathers and
    scatters, which carry no fusion name);
  - the costliest kernels, to <out>/trace_summary.txt.
Kernels run inside XLA command buffers, so the trace names no HLO op;
a kernel named `input_reduce_fusion_13` is the fusion instruction
`input_reduce_fusion.13` of the compiled advance, whose op_name metadata
carries the named scopes.  The compiled HLO text is saved beside the
trace (advance_hlo.txt.gz) so the reduction can be rerun offline:
    python tools/trace_advance.py --reduce <out_dir>

Usage:  python tools/trace_advance.py [out_dir]    (default chiprun_out/trace)
"""

import glob
import gzip
import json
import os
import re
import subprocess
import sys
import time
from collections import defaultdict

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_REPLICA = 64
N_ROUNDS = 20
WINDOW = "md_window"


def op_names_by_instruction(hlo_text):
    """HLO instruction name -> metadata op_name, from compiled HLO text."""
    out = {}
    pat = re.compile(r'^\s*(?:ROOT )?%?([\w.\-]+) = .*?op_name="([^"]*)"')
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def union_length(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path, op_names, out_dir):
    from jax.profiler import ProfileData
    prof = ProfileData.from_file(path)
    window = None
    device_lines = {}     # line name -> [(start, end, name, hlo_op)]
    lines_seen = []
    for plane in prof.planes:
        for line in plane.lines:
            events = list(line.events)
            lines_seen.append((plane.name, line.name, len(events)))
            if not plane.name.startswith("/device:GPU"):
                for ev in events:
                    if ev.name == WINDOW:
                        window = (ev.start_ns, ev.start_ns + ev.duration_ns)
                continue
            rows = device_lines.setdefault(f"{plane.name}|{line.name}", [])
            for ev in events:
                stats = {k: v for k, v in ev.stats}
                hlo_op = str(stats.get("hlo_op", ev.name))
                rows.append((ev.start_ns, ev.start_ns + ev.duration_ns,
                             ev.name, hlo_op))
    # one view of the kernels: the per-op line when the profiler writes
    # one, else the CUDA stream lines; never both, which would count each
    # kernel twice
    chosen = [k for k in device_lines if k.endswith("|XLA Ops")] or \
        [k for k in device_lines if "Stream" in k]
    kernels = [ev for k in chosen for ev in device_lines[k]]
    if window is None:
        raise RuntimeError("trace has no md_window annotation")
    lo, hi = window
    kernels = [k for k in kernels if k[1] > lo and k[0] < hi]
    busy = union_length([(max(s, lo), min(e, hi)) for s, e, _, _ in kernels])
    total = sum(e - s for s, e, _, _ in kernels)

    def scope_of(kernel, hlo_op):
        if hlo_op in op_names:
            return op_names[hlo_op]
        m = re.match(r"(.*)_(\d+)$", kernel)
        instr = f"{m.group(1)}.{m.group(2)}" if m else kernel
        return op_names.get(instr) or op_names.get(kernel) or ""

    by_kernel = defaultdict(lambda: [0, 0, ""])
    shares = defaultdict(int)
    for s, e, name, hlo_op in kernels:
        scope = scope_of(name, hlo_op)
        if not scope and ("gemm" in name or "cutlass" in name):
            scope = "gemm"
        d = by_kernel[name]
        d[0] += e - s
        d[1] += 1
        d[2] = scope
        if "bp_solve" in scope:
            shares["bp_solve"] += e - s
        elif "pair_spline" in scope:
            shares["pair_spline"] += e - s
        elif scope == "gemm":
            shares["gemm"] += e - s
        elif not scope:
            shares["unattributed"] += e - s
    result = {
        "window_ms": (hi - lo) / 1e6,
        "kernel_lines": chosen,
        "kernel_events": len(kernels),
        "device_busy_ms": busy / 1e6,
        "device_idle_share": 1.0 - busy / (hi - lo),
        "kernel_time_ms": total / 1e6,
        "bp_solve_share": shares["bp_solve"] / max(total, 1),
        "pair_spline_share": shares["pair_spline"] / max(total, 1),
        "gemm_share": shares["gemm"] / max(total, 1),
        "unattributed_share": shares["unattributed"] / max(total, 1),
    }
    with open(os.path.join(out_dir, "trace_summary.txt"), "w") as f:
        f.write(json.dumps(result, indent=1) + "\n\nplanes/lines:\n")
        for p, ln, n in lines_seen:
            f.write(f"  {p} | {ln} | {n} events\n")
        f.write("\nkernels by device time:\n")
        for name, (t, n, scope) in sorted(by_kernel.items(),
                                          key=lambda kv: -kv[1][0])[:60]:
            f.write(f"  {t / 1e6:9.3f} ms {n:6d}x  {name[:60]:60s} "
                    f"{scope[-90:]}\n")
    return result


def reduce_saved(out_dir):
    """Rerun the reduction on a saved trace and HLO text."""
    path = sorted(glob.glob(os.path.join(out_dir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    with gzip.open(os.path.join(out_dir, "advance_hlo.txt.gz"), "rt") as f:
        op_names = op_names_by_instruction(f.read())
    print(json.dumps(reduce_trace(path, op_names, out_dir)))


def main():
    if sys.argv[1:2] == ["--reduce"]:
        return reduce_saved(os.path.abspath(sys.argv[2]))
    out_dir = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                              else os.path.join(ROOT, "chiprun_out", "trace"))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"trace_advance.py: no GPU (JAX runs on {dev.platform})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.splitlines()[0].strip()
    print(card)
    from upside_md.bench_systems import UBIQUITIN, build_full_system
    from upside_md.compile_cache import enable_compile_cache
    from upside_md.md.sim import Simulation
    enable_compile_cache()
    os.environ.pop("UPSIDE_PARAM_DIR", None)
    system, params, pos, _ = build_full_system(seq=UBIQUITIN)
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     do_recenter=False)
    state = sim.initial_state(pos, params, seed=1, temperature=0.85,
                              n_replica=N_REPLICA)
    for _ in range(2):
        state = jax.block_until_ready(
            sim.advance(state, params, N_ROUNDS, True))
    hlo = Simulation.advance.lower(sim, state, params, N_ROUNDS,
                                   True).compile().as_text()
    op_names = op_names_by_instruction(hlo)

    os.makedirs(out_dir, exist_ok=True)
    with gzip.open(os.path.join(out_dir, "advance_hlo.txt.gz"), "wt") as f:
        f.write(hlo)
    jax.profiler.start_trace(out_dir)
    with jax.profiler.TraceAnnotation(WINDOW):
        t0 = time.perf_counter()
        state = jax.block_until_ready(
            sim.advance(state, params, N_ROUNDS, True))
        wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(out_dir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    result = reduce_trace(path, op_names, out_dir)
    result.update(card=card, device_kind=dev.device_kind,
                  traced_call_wall_s=wall, n_replica=N_REPLICA,
                  n_rounds=N_ROUNDS, hlo_instructions_with_op_name=len(op_names))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
