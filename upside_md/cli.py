"""`upside` command-line driver (reference: src/main.cpp:317-752).

Same flag surface and run semantics: durations/intervals in simulation time
converted to integer rounds of 3*dt, per-replica temperatures, sqrt-space
annealing, pivot/jump MC from /input groups, Hamiltonian/temperature
replica exchange over swap sets, /output logging, and final
throughput/equipartition/acceptance reports.

All configs are batched into one replica ensemble advanced by a single
jitted, vmapped round function (the reference runs one OpenMP thread per
system).  Heterogeneous parameters across configs are supported when the
systems share their graph structure (Hamiltonian replica exchange).
"""

from __future__ import annotations

import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from .compile_cache import enable_compile_cache
from .config.reader import load_system
from .io.logger import H5Logger
from .md.mc import JumpSampler, PivotSampler
from .md.replica import ReplicaExchange, parse_swap_sets
from .md.sim import Simulation
from .md.thermostat import REPLICA_EXCHANGE_STREAM, stream_key


def potential_deriv_agreement(system, params, pos, eps=1e-3):
    """Finite-difference force check (main.cpp:279-315): returns the
    relative RMS deviation between autodiff and central differences."""
    g = np.asarray(jax.grad(system.energy)(jnp.asarray(pos), params))
    fd = np.zeros_like(g)
    pos = np.asarray(pos, np.float64)
    f = jax.jit(system.energy)
    for i in range(pos.shape[0]):
        for d in range(3):
            pp = pos.copy(); pp[i, d] += eps
            pm = pos.copy(); pm[i, d] -= eps
            fd[i, d] = (float(f(jnp.asarray(pp, jnp.float32), params)) -
                        float(f(jnp.asarray(pm, jnp.float32), params))) / (2 * eps)
    num = np.sqrt(np.mean((g - fd) ** 2))
    den = np.sqrt(np.mean(fd ** 2))
    return num / max(den, 1e-12)


def recycle_structures(path, n_replica, n_atom):
    """Load a pickle of one or more structures and recycle them over the
    replica slots (slot i gets structure i mod n_structures) — the
    reference's --initial-structure semantics for replica ensembles
    (upside_config.py:1296-1301 help text; run_upside.py slices the list
    per generated config)."""
    import pickle

    with open(path, "rb") as f:
        structs = np.asarray(pickle.load(f, encoding="latin1"), np.float64)
    if structs.ndim == 3 and structs.shape[-1] == 1:   # (n_atom, 3, 1)
        structs = structs[None, :, :, 0]
    elif structs.ndim == 2:                            # (n_atom, 3)
        structs = structs[None]
    elif structs.ndim == 4 and structs.shape[-1] == 1:
        structs = structs[..., 0]
    if structs.shape[1:] != (n_atom, 3):
        sys.exit(f"{path}: expected structures of shape ({n_atom}, 3), "
                 f"got {structs.shape}")
    return structs[np.arange(n_replica) % structs.shape[0]]


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Upside-MD in JAX: coarse-grained protein MD")
    p.add_argument("--time-step", type=float, default=0.009)
    p.add_argument("--duration", type=float, required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--temperature", default="1.0",
                   help="comma-separated list (one per config or a single value)")
    p.add_argument("--swap-set", action="append", default=[],
                   help="like 0-1,2-3 (non-overlapping within a set)")
    p.add_argument("--anneal-factor", type=float, default=1.0)
    p.add_argument("--anneal-duration", type=float, default=-1.0)
    p.add_argument("--frame-interval", type=float, required=True)
    p.add_argument("--replica-interval", type=float, default=0.0)
    p.add_argument("--monte-carlo-interval", type=float, default=0.0)
    p.add_argument("--thermostat-interval", type=float, default=-1.0)
    p.add_argument("--thermostat-timescale", type=float, default=5.0)
    p.add_argument("--disable-recentering", action="store_true")
    p.add_argument("--disable-z-recentering", action="store_true")
    p.add_argument("--log-level", default="detailed",
                   choices=["basic", "detailed", "extensive"])
    p.add_argument("--potential-deriv-agreement", action="store_true")
    p.add_argument("--set-param", default="",
                   help="HDF5 file of node-name -> flat parameter arrays to "
                        "override before running (main.cpp:384-395)")
    p.add_argument("--verbose", action="store_true", default=True)
    p.add_argument("--initial-structures", default="",
                   help="pickle of one or more (n_atom, 3) structures; "
                        "recycled over the replica slots when fewer "
                        "structures than replicas are given (reference "
                        "upside_config.py:1296-1301 semantics), "
                        "overriding the configs' stored positions")
    p.add_argument("configs", nargs="+", help=".up configuration files")
    args = p.parse_args(argv)
    enable_compile_cache()

    dt = args.time_step
    round_time = 3 * dt
    n_round = int(round(args.duration / round_time))

    temps = [float(x) for x in args.temperature.split(",")]
    n_sys = len(args.configs)
    if len(temps) == 1:
        temps = temps * n_sys
    if len(temps) != n_sys:
        sys.exit(f"got {len(temps)} temperatures for {n_sys} systems")

    # load all systems; batch if structurally identical.  When configs
    # carry different parameter values (same graph), every replica slot
    # gets its own parameter pytree — Hamiltonian replica exchange.
    loaded = [load_system(c) for c in args.configs]
    system = loaded[0][0]
    params0 = loaded[0][1]
    aux = loaded[0][3]
    pos = np.stack([ld[2] for ld in loaded])
    if args.initial_structures:
        pos = recycle_structures(args.initial_structures, n_sys,
                                 pos.shape[1])

    import jax as _jax

    def _params_equal(a, b):
        leaves_a = _jax.tree.leaves(a)
        leaves_b = _jax.tree.leaves(b)
        return all(np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(leaves_a, leaves_b))

    hamiltonian = any(not _params_equal(params0, ld[1]) for ld in loaded[1:])
    ham_spec = False
    if hamiltonian:
        # stack only the leaves that differ across slots: shared tables
        # keep the pair kernels' batched fast paths (see
        # md.sim.stack_param_ensembles)
        from .md.sim import stack_param_ensembles
        params0, ham_spec = stack_param_ensembles([ld[1] for ld in loaded])

    if args.set_param:
        import h5py

        from .engine import Upside
        new_per_config = []
        with h5py.File(args.set_param, "r") as pf:
            overrides = {name: np.asarray(pf[name]) for name in pf}
        for ld in (loaded if hamiltonian else loaded[:1]):
            eng = Upside(ld[0], ld[1], jnp.asarray(pos[0]))
            for node_name, val in overrides.items():
                eng.set_param(val, node_name)
            new_per_config.append(eng.params)
        if hamiltonian:
            from .md.sim import stack_param_ensembles
            params0, ham_spec = stack_param_ensembles(new_per_config)
        else:
            params0 = new_per_config[0]

    pivot = jump = None
    if args.monte_carlo_interval > 0 and "pivot_moves" in aux:
        pm = aux["pivot_moves"]
        pivot = PivotSampler.from_tables(pm["pivot_atom"], pm["pivot_range"],
                                         pm["pivot_restype"],
                                         pm["proposal_pot"])
    if args.monte_carlo_interval > 0 and "jump_moves" in aux:
        jm = aux["jump_moves"]
        jump = JumpSampler(jm["atom_range"], jm["sigma_trans"],
                           jm["sigma_rot"])

    sim = Simulation(
        system, dt=dt, duration=args.duration,
        thermostat_timescale=args.thermostat_timescale,
        thermostat_interval=(args.thermostat_interval
                             if args.thermostat_interval > 0 else None),
        frame_interval=args.frame_interval,
        mc_interval=(args.monte_carlo_interval or None),
        pivot_sampler=pivot, jump_sampler=jump,
        anneal_factor=args.anneal_factor,
        anneal_duration=(args.anneal_duration
                         if args.anneal_duration > 0 else None),
        do_recenter=not args.disable_recentering,
        xy_recenter_only=args.disable_z_recentering)

    state = sim.initial_state(jnp.asarray(pos), params0, seed=args.seed,
                              temperature=temps, n_replica=n_sys)

    if args.potential_deriv_agreement:
        p_first = loaded[0][1] if hamiltonian else params0
        _, _, per_term = system.evaluate(jnp.asarray(pos[0]), p_first)
        for name, v in sorted(per_term.items()):
            print(f"{name}: {float(v): 4.3f}")
        rel = potential_deriv_agreement(system, p_first, pos[0])
        print(f"overall potential relative error:  {rel:.5f}")

    rex = None
    replica_interval = 0
    if args.replica_interval > 0:
        swap_sets = parse_swap_sets(args.swap_set, n_sys)
        if not swap_sets:
            sys.exit("replica exchange requested but no swap sets proposed")
        rex = ReplicaExchange(swap_sets, n_sys)
        replica_interval = max(1, int(round(args.replica_interval / round_time)))

    loggers = [H5Logger(c, args.log_level,
                        invocation=" ".join(sys.argv))
               for c in args.configs]
    # ONE jitted frame evaluation: potential + per-node streams (gated by
    # --log-level; reference state_logger.h add_logger registrations, see
    # io/streams.py) + hbond console count from a single graph pass, with
    # per-slot parameters in Hamiltonian mode
    from .io.streams import make_frame_fn
    frame_fn, has_hbond = make_frame_fn(system, args.log_level,
                                        params_batched=ham_spec)

    # signal-safe shutdown (reference main.cpp:26-89, 610-674): finish the
    # current chunk, flush every logger, restore handlers, re-raise
    import signal
    stop_requested = []
    old_handlers = {}

    def _request_stop(signum, frame):
        stop_requested.append(signum)
        print(f"\nreceived signal {signum}; finishing current chunk and "
              "flushing logs", flush=True)

    for sig in (signal.SIGINT, signal.SIGTERM):
        old_handlers[sig] = signal.signal(sig, _request_stop)
    last_mc_stats = {}
    replica_index = jnp.arange(n_sys)
    beta = jnp.asarray([1.0 / t for t in temps], jnp.float32)
    if hamiltonian:
        from .md.sim import param_axes
        _p_ax = param_axes(params0, ham_spec)
        energy_of = jax.jit(lambda pp: jax.vmap(
            system.energy, in_axes=(0, _p_ax))(pp, params0))
    else:
        energy_of = jax.jit(jax.vmap(lambda p: system.energy(p, params0)))
    rex_stats = None

    t_start = time.time()
    frame_rounds = sim.frame_interval
    next_events = sorted({n_round} | (
        {r for r in range(replica_interval, n_round + 1, replica_interval)}
        if replica_interval else set()))

    done = 0
    while done < n_round:
        target = min(done + frame_rounds, n_round)
        if replica_interval:
            next_rep = ((done // replica_interval) + 1) * replica_interval
            target = min(target, next_rep)
        state = sim.advance(state, params0, target - done, True,
                            ham_spec)
        done = target

        if done % frame_rounds == 0 or done == n_round or stop_requested:
            if sim.do_recenter:
                state = sim.recentered(state)
            kin = np.asarray(sim.kinetic_energy(state))
            pos_np = np.asarray(state.pos)
            pot_dev, stream_dev, hb_dev = frame_fn(
                state.pos, params0, {"n_deriv_evals": 3 * done})
            pot = np.asarray(pot_dev)
            streams = ({k: np.asarray(v) for k, v in stream_dev.items()}
                       or None)
            hb = np.asarray(hb_dev) if has_hbond else None
            # per-frame MC stats with reset semantics
            # (monte_carlo_sampler.h:28-37)
            mc_streams = {}
            for mc_name, stats in (("pivot", state.pivot_stats),
                                   ("jump", state.jump_stats)):
                if (pivot if mc_name == "pivot" else jump) is None:
                    continue
                cur = np.asarray(stats)
                prev = last_mc_stats.get(mc_name, np.zeros_like(cur))
                mc_streams[f"{mc_name}_stats"] = (cur - prev).astype(np.int32)
                last_mc_stats[mc_name] = cur
            # BP solve health from the threaded warm-start cache: the
            # last solve's final deviation and sweep count (reference
            # n_bad_solve, rotamer.cpp:657-659)
            from .nodes.rotamer import bp_solve_health
            for cname, cval in (state.cache or {}).items():
                if system.by_name[cname].node_type.name != "rotamer":
                    continue
                health = bp_solve_health(cval)
                if health is not None:
                    ctol = float(system.by_name[cname].consts.get(
                        "tol", 1e-3))
                    mc_streams[f"{cname}_n_bad_solve"] = \
                        (health[0] > ctol).astype(np.int32)
                    mc_streams[f"{cname}_solve_iters"] = \
                        health[1].astype(np.int32)
            for ns, lg in enumerate(loggers):
                lg.log_frame("pos", pos_np[ns][None])
                lg.log_frame("kinetic", np.array([kin[ns]]))
                lg.log_frame("potential", np.array([pot[ns]]))
                lg.log_frame("time", np.float64(3 * dt * done))
                lg.log_frame("temperature",
                             np.array([np.asarray(state.temperature)[ns]]))
                lg.log_frame("replica_index",
                             np.array([int(np.asarray(replica_index)[ns])]))
                if streams is not None:
                    for name, val in streams.items():
                        lg.log_frame(name, val[ns])
                for name, val in mc_streams.items():
                    lg.log_frame(name, val[ns])
                if rex_stats is not None:
                    # (n_swap_pairs, 2) across all sets (main.cpp:211-218)
                    lg.log_frame("replica_cumulative_swaps",
                                 np.concatenate(
                                     [np.asarray(s) for s in rex_stats]
                                 ).astype(np.int64))
            if args.verbose:
                rg = np.sqrt(((pos_np[0] - pos_np[0].mean(0)) ** 2
                              ).sum(-1).mean())
                temp0 = float(np.asarray(state.temperature).reshape(-1)[0])
                hb_txt = f"{float(hb[0]):5.1f} hbonds, " if hb is not None \
                    else ""
                print(f"{done * 3 * dt:.0f} / {args.duration:.0f} "
                      f"temp {temp0:.2f} {hb_txt}"
                      f"Rg {rg:5.1f} A, potential {pot[0]: 8.2f}",
                      flush=True)

        if stop_requested:
            break

        if replica_interval and done % replica_interval == 0 and rex:
            key = stream_key(args.seed, REPLICA_EXCHANGE_STREAM, done)
            # the solver warm-start cache swaps WITH the configurations
            new_pos, replica_index, rex_stats, _, new_cache = \
                rex.attempt_swaps(
                    key, state.pos, replica_index, beta, energy_of,
                    rex_stats, slot_independent=not hamiltonian,
                    aux=state.cache)
            state = state._replace(pos=new_pos, cache=new_cache)

    elapsed = time.time() - t_start
    print(f"\nfinished in {elapsed:.1f} seconds "
          f"({elapsed * 1e6 / max(n_sys, 1) / max(done, 1) / 3:.2f} "
          f"us/system/step, "
          f"{done * 3 * dt / elapsed * 3600:.1e} "
          f"simulation_time_unit/hour)")

    # equipartition report over the last half of the trajectory
    ratios = []
    for ns, lg in enumerate(loggers):
        lg.flush()
        kin = np.asarray(lg._out["kinetic"])[:, 0]
        ratios.append(kin[len(kin) // 2:].mean() / (1.5 * temps[ns]))
        lg.close()
    print("avg_kinetic_energy/1.5kT " +
          " ".join(f"{r: .3f}" for r in ratios))

    if pivot is not None:
        ps = np.asarray(state.pivot_stats)
        acc = ps[..., 0].sum() / max(ps[..., 1].sum(), 1)
        print(f"pivot_success: {acc:.4f}")
    if jump is not None:
        js = np.asarray(state.jump_stats)
        acc = js[..., 0].sum() / max(js[..., 1].sum(), 1)
        print(f"jump_success: {acc:.4f}")

    # restore handlers; re-raise the deferred signal so callers see the
    # standard death-by-signal status (main.cpp:73-86)
    for sig, h in old_handlers.items():
        signal.signal(sig, h)
    if stop_requested:
        print(f"exiting after signal {stop_requested[0]} "
              f"(all {done}-round frames flushed)", flush=True)
        signal.signal(stop_requested[0], signal.SIG_DFL)
        signal.raise_signal(stop_requested[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
