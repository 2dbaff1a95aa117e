"""Sweep the BP damping factor x warm-start strategy along a saved MD
trajectory (CPU; solver math is backend-independent).

Damping only shapes the solve's convergence path, never its fixed point,
so any value that still converges within max_iter yields the same
marginals to tol — it is a legitimate solver-schedule tuning knob, unlike
tol itself.  The reference ships damping=0.4 (rotamer.cpp solver
defaults); this measures whether a lighter mix converges in fewer sweeps
at production tol on a real trajectory.

Method: run the production trajectory once (warm-started, at whatever
damping the bench config ships), recording positions and the warm-start
cache before every force evaluation; converged beliefs are strategy- and
damping-independent (same fixed point), so each (damping, init)
candidate can be counted against that shared history.  Candidates that hit max_iter are reported — a
damping that fails to converge changes answers and is disqualified.

Usage:  python tools/bp_damping_exp.py [n_rounds] [seq]
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
# candidate inits are constructed HERE; the node's own (default-on)
# extrapolation must not stack on top of them
os.environ["UPSIDE_BP_EXTRAP"] = "off"
os.environ.setdefault("JAX_ENABLE_X64", "0")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax
import numpy as np

from bp_extrap_exp import extrapolate  # noqa: E402  (same directory)


def main():
    n_rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 25
    seq_name = sys.argv[2] if len(sys.argv) > 2 else "UBIQUITIN"

    from upside_md import bench_systems as bs
    from upside_md.compile_cache import enable_compile_cache
    enable_compile_cache()
    from upside_md.md.integrator import INTEGRATOR_COEFFS
    from upside_md.md.sim import Simulation
    from upside_md.md.thermostat import THERMOSTAT_STREAM, stream_key

    system, params, pos, aux = bs.build_full_system(
        seq=getattr(bs, seq_name))
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     do_recenter=False)
    rot = [s.name for s in system.specs if s.node_type.name == "rotamer"][0]
    rot_spec = [s for s in system.specs if s.name == rot][0]
    max_iter = int(rot_spec.consts["max_iter"])
    config_damping = float(rot_spec.consts["damping"])

    @jax.jit
    def stage_eval(p, cache):
        g, new_cache = jax.grad(
            lambda q: system.energy_and_cache(q, params, cache=cache),
            has_aux=True)(p)
        return g, new_cache

    # ---- pass 1: production trajectory, record (pos, cache-history) ----
    state = sim.initial_state(pos, params, seed=1234, temperature=0.85)
    pos_d, mom = state.pos, state.mom
    cache = state.cache
    dt = sim.dt
    mom_w, pos_w = INTEGRATOR_COEFFS["verlet"]

    evals = []   # (pos, last_entry, prev_entry) before each evaluation
    hist = []
    for nr in range(n_rounds):
        if nr % sim.thermostat_interval == 0:
            key = stream_key(state.seed, THERMOSTAT_STREAM, nr + 1)
            mom = sim.thermostat.apply(key, mom, state.temperature)
        for stage in range(3):
            if len(hist) == 2:
                evals.append((np.asarray(pos_d),
                              jax.tree.map(np.asarray, hist[1]),
                              jax.tree.map(np.asarray, hist[0])))
            g, cache = stage_eval(pos_d, cache)
            mom = mom - (dt * mom_w[stage]) * g
            pos_d = pos_d + (dt * pos_w[stage]) * mom
            hist = (hist + [cache[rot]])[-2:]
    print(f"{seq_name}: trajectory recorded, {len(evals)} evaluations",
          flush=True)

    # ---- pass 2: count sweeps per (damping, init strategy) -------------
    # "unif" = the uniform init_cache beliefs, i.e. what the very first
    # evaluation of a run (or a freshly reset replica) sees — the cold-
    # start robustness check for low damping
    unif = system.init_cache()[rot]
    strategies = {"warm": None, "log1": (1.0, True), "unif": "unif"}
    print(f"{'damping':>8s} " + "".join(
        f"| {s:>5s} mean med p90 max hit " for s in strategies))
    for damping in (0.4, 0.3, 0.2, 0.1, 0.0):
        rot_spec.consts["damping"] = damping
        row = f"{damping:8.1f} "

        def count_fn():
            @jax.jit
            def count_eval(p, cache):
                _, nc = system.energy_and_cache(p, params, cache=cache)
                return nc[rot].sweeps
            return count_eval

        count_eval = count_fn()
        for sname, cfg in strategies.items():
            iters = []
            for p, last, prev in evals:
                c = dict(cache)
                if cfg == "unif":
                    c[rot] = unif
                elif cfg:
                    c[rot] = extrapolate(last, prev, cfg[0], cfg[1])
                else:
                    c[rot] = jax.tree.map(np.asarray, last)
                iters.append(int(count_eval(p, c)))
            v = np.asarray(iters)
            row += (f"| {v.mean():5.1f} {np.median(v):4.0f} "
                    f"{np.percentile(v, 90):4.0f} {v.max():4d} "
                    f"{(v >= max_iter).sum():3d} ")
        print(row, flush=True)
    rot_spec.consts["damping"] = config_damping


if __name__ == "__main__":
    main()
