"""Measure BP warm-start sweep counts along a real MD trajectory (CPU).

The rotamer BP solve warm-starts from the previous force evaluation's
beliefs (reference analog: Upside keeps its message arrays across calls,
rotamer.cpp:988-1061).  Between consecutive evaluations the positions move
by O(dt/3), so the beliefs drift smoothly — which suggests initializing
from an *extrapolation* of the last two evaluations instead of the last
one.  BP converges to the same fixed point from any positive init, so the
strategy only changes the sweep count, never the answer beyond tol.

This script drives the production integrator host-side (one jitted energy
evaluation per stage; the rotamer cache entry carries the solve's sweep
count) and, at every force evaluation, counts the sweeps
each candidate init would have needed on the SAME trajectory:

  warm     previous evaluation's beliefs (production today)
  lin1     m1 + 1.0*(m1-m0), clipped positive    (linear extrapolation)
  lin05    m1 + 0.5*(m1-m0)
  log1     m1 * (m1/m0)^1.0                      (log-space extrapolation)

Solver math is backend-independent, so CPU sweep counts hold on the GPU
for one replica; under vmap every replica sweeps until the slowest one
converges.

Usage:  python tools/bp_extrap_exp.py [n_rounds] [seq]
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
import jax.numpy as jnp
import numpy as np


def extrapolate3(c2, c1, c0, which="nb"):
    """Quadratic (3-point) log-space extrapolation: L3 = 3L2 - 3L1 + L0,
    applied to node beliefs only by default."""
    nb2, nb1, nb0 = (np.asarray(c[0], np.float64) for c in (c2, c1, c0))
    L2, L1, L0 = (np.log(np.maximum(m, 1e-12)) for m in (nb2, nb1, nb0))
    m = np.exp(np.clip(3 * L2 - 3 * L1 + L0, L2 - 2.5, L2 + 2.5))
    nb = np.where(nb2 > 0, np.maximum(m, 1e-8), 0.0)
    nb = nb / np.maximum(nb.max(-1, keepdims=True), 1e-10)
    return c2._replace(node_belief=jnp.asarray(nb, jnp.float32))


def extrapolate(c1, c0, alpha, log_space=False, which="both"):
    """Candidate init from the last two cache entries (numpy, host side).
    which: extrapolate "both" arrays, only node beliefs ("nb"), or only
    edge messages ("eb") — the cost asymmetry is large (eb is ~100x
    bigger), so a one-sided variant that keeps most of the win pays."""
    nb1, eb1 = np.asarray(c1[0], np.float64), np.asarray(c1[1], np.float64)
    nb0, eb0 = np.asarray(c0[0], np.float64), np.asarray(c0[1], np.float64)
    if which == "nb":
        eb0 = eb1
    elif which == "eb":
        nb0 = nb1

    def ex(m1, m0):
        if log_space:
            r = m1 / np.maximum(m0, 1e-12)
            m = m1 * np.clip(r, 0.1, 10.0) ** alpha
        else:
            m = m1 + alpha * (m1 - m0)
        # keep exact zeros (invalid slots / masked entries), floor the rest
        return np.where(m1 > 0, np.maximum(m, 1e-8), 0.0)

    nb = ex(nb1, nb0)
    nb = nb / np.maximum(nb.max(-1, keepdims=True), 1e-10)
    eb = ex(eb1, eb0)
    s = eb.sum(-1, keepdims=True)
    # real-edge messages are sum-normalized by the solver; non-edges are
    # exactly 1.0 in both histories and extrapolate to 1.0 (sum 6) — keep
    # the solver's convention by renormalizing only rows that moved
    moved = np.abs(eb - eb1).max(-1, keepdims=True) > 0
    eb = np.where(moved, eb / np.maximum(s, 1e-10), eb)
    return c1._replace(node_belief=jnp.asarray(nb, jnp.float32),
                       edge_belief=jnp.asarray(eb, jnp.float32))


def main():
    n_rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    seq_name = sys.argv[2] if len(sys.argv) > 2 else "UBIQUITIN"

    from upside_md import bench_systems as bs
    from upside_md.compile_cache import enable_compile_cache
    enable_compile_cache()
    from upside_md.md.integrator import INTEGRATOR_COEFFS
    from upside_md.md.thermostat import THERMOSTAT_STREAM, stream_key

    seq = getattr(bs, seq_name)
    system, params, pos, aux = bs.build_full_system(seq=seq)
    from upside_md.md.sim import Simulation
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     do_recenter=False)

    rot_names = [s.name for s in system.specs
                 if s.node_type.name == "rotamer"]
    assert rot_names, "full system should have a rotamer node"
    rot = rot_names[0]

    @jax.jit
    def stage_eval(p, cache):
        g, new_cache = jax.grad(
            lambda q: system.energy_and_cache(q, params, cache=cache),
            has_aux=True)(p)
        return g, new_cache

    @jax.jit
    def count_eval(p, cache):
        _, new_cache = system.energy_and_cache(p, params, cache=cache)
        return new_cache[rot].sweeps

    state = sim.initial_state(pos, params, seed=1234, temperature=0.85)
    pos_d, mom = state.pos, state.mom
    cache = state.cache
    dt = sim.dt
    mom_w, pos_w = INTEGRATOR_COEFFS["verlet"]

    strategies = {
        "warm": None,
        "log1": (1.0, True, "both"),
        "log1nb": (1.0, True, "nb"),
        # alpha sweep around the production default (round-5: does a
        # damped or overshot nb extrapolation cut sweeps further?)
        "log06nb": (0.6, True, "nb"),
        "log08nb": (0.8, True, "nb"),
        "log12nb": (1.2, True, "nb"),
        "quadnb": "quad",
    }
    counts = {k: [] for k in strategies}
    hist = []  # last three rotamer cache entries (numpy-backed jax arrays)

    n_eval = 0
    for nr in range(n_rounds):
        if nr % sim.thermostat_interval == 0:
            key = stream_key(state.seed, THERMOSTAT_STREAM, nr + 1)
            mom = sim.thermostat.apply(key, mom, state.temperature)
        for stage in range(3):
            if len(hist) == 3:
                for name, cfg in strategies.items():
                    c = dict(cache)
                    if cfg == "quad":
                        c[rot] = extrapolate3(hist[2], hist[1], hist[0])
                    elif cfg is not None:
                        c[rot] = extrapolate(hist[2], hist[1], *cfg)
                    counts[name].append(int(count_eval(pos_d, c)))
            g, cache = stage_eval(pos_d, cache)
            n_eval += 1
            mom = mom - (dt * mom_w[stage]) * g
            pos_d = pos_d + (dt * pos_w[stage]) * mom
            hist = (hist + [cache[rot]])[-3:]
        if nr % 10 == 0:
            done = {k: len(v) for k, v in counts.items()}["warm"]
            print(f"round {nr}: {done} measured evals", flush=True)

    print(f"\n{seq_name}, {n_eval} force evaluations, production settings "
          f"(tol/damping/chunk from the builder):")
    for name, v in counts.items():
        v = np.asarray(v)
        print(f"  {name:6s} sweeps: mean {v.mean():5.2f}  median "
              f"{np.median(v):5.1f}  p90 {np.percentile(v, 90):5.1f}  "
              f"max {v.max():3d}")


if __name__ == "__main__":
    main()
