"""In-loop A/B cost anatomy of the full-forcefield force evaluation.

Times `Simulation.advance` (a jitted fori_loop over integration rounds —
3 force evaluations per round) at 64 replicas on the GPU, as the full
system and as ablated systems with one subsystem's node family removed.
The marginal cost of a block is the full time minus the ablated time.
Every timed call ends in jax.block_until_ready.

Usage:  python tools/perf_ab.py [n_replica] [n_rounds]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from upside_md.bench_systems import UBIQUITIN, build_full_system
from upside_md.compile_cache import enable_compile_cache
from upside_md.md.sim import Simulation
from upside_md.system import System

ABLATIONS = {
    # name -> node-type names removed (with every dependent node)
    "rotamer (BP + pair kernel)": ["rotamer"],
    "hbond_coverage pair kernels": ["hbond_coverage"],
    "environment chain": ["environment_coverage", "uniform_transform",
                          "nonlinear_coupling", "weighted_pos",
                          "linear_coupling_uniform",
                          "linear_coupling_with_inactivation"],
    "placements": ["placement_fixed_point_only",
                   "placement_fixed_point_vector_only",
                   "placement_fixed_point_vector_scalar",
                   "placement_fixed_scalar", "placement_scalar",
                   "placement_point_only", "placement_point_vector_only"],
    "backbone steric": ["backbone_pairs"],
    "protein_hbond + energy": ["protein_hbond"],
    "rama": ["rama_map_pot"],
    "affine_alignment": ["affine_alignment"],
}


def ablate(system, kill_types):
    """Remove nodes of the given types plus every transitive dependent."""
    kill = {s.name for s in system.specs if s.node_type.name in kill_types}
    changed = True
    while changed:
        changed = False
        for s in system.specs:
            if s.name not in kill and any(a in kill for a in s.args):
                kill.add(s.name)
                changed = True
    specs = [s for s in system.specs if s.name not in kill]
    return System(system.n_atom, specs), kill


def timed_advance(system, params, pos, n_replica, n_rounds, seed=1234):
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     do_recenter=False)
    state = sim.initial_state(pos, params, seed=seed, temperature=0.85,
                              n_replica=n_replica)
    state = jax.block_until_ready(sim.advance(state, params, n_rounds, True))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state = jax.block_until_ready(
            sim.advance(state, params, n_rounds, True))
        times.append(time.perf_counter() - t0)
    return sorted(times)[1]


def main():
    n_replica = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    n_rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"no GPU: JAX found {jax.devices()[0].platform}")
    system, params, pos, aux = build_full_system(seq=UBIQUITIN)

    t_full = timed_advance(system, params, pos, n_replica, n_rounds)
    evals = 3 * n_rounds
    print(f"full FF: {t_full*1e3:8.2f} ms/loop = "
          f"{t_full*1e3/evals:6.3f} ms/eval  "
          f"({evals*n_replica/t_full:,.0f} steps/s)")

    for label, types in ABLATIONS.items():
        sub, killed = ablate(system, types)
        if len(sub.specs) == len(system.specs):
            continue
        t = timed_advance(sub, params, pos, n_replica, n_rounds)
        print(f"  - {label:35s} {t*1e3:8.2f} ms  marginal "
              f"{(t_full-t)*1e3/evals:6.3f} ms/eval  "
              f"(removed {len(killed)} nodes)")


if __name__ == "__main__":
    main()
