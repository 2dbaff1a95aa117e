"""Smoke run of the main path on the GPU.

    python chip_smoke.py               one GPU: phases 1-6 below
    python chip_smoke.py --devices 4   four GPUs: the replica mesh only

One process.  On one GPU it
  1. checks that JAX runs on a GPU (exits non-zero otherwise) and prints
     the card;
  2. builds the flagship system in memory: 76-residue ubiquitin, full
     forcefield, from the seeded parameter libraries (no file is read);
  3. compares energy, per-node energies and forces of 2 replicas on the
     GPU (default precision and "highest") with the same computation on
     the CPU backend of this process (float32, "highest");
  4. runs MD at 64 replicas with warm-started BP caches, equilibrates,
     times it, and checks positions and kinetic energy;
  5. runs the `upside` CLI in process on .up files (4-replica temperature
     ladder with swaps) and reads the trajectory back;
  6. prints {"ok": true, "device": {...}} as its last line.
Any failed check or exception exits non-zero before that line.

With --devices 4 it runs the replica mesh of parallel/mesh.py across four
GPUs and compares it with one GPU: sharded advance, replica exchange,
the psum training step, the Hamiltonian advance, and an audit that the
compiled sharded advances hold no cross-device collectives.

The printed rates and memory are smoke numbers, not a benchmark.
"""

import argparse
import json
import os
import subprocess
import sys
import time

# the CPU backend serves as the in-process reference, so keep it available
# when JAX_PLATFORMS names the GPU alone
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"
# the seeded libraries, never a parameter directory outside the checkout
os.environ.pop("UPSIDE_PARAM_DIR", None)

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(HERE, ".scratch")

# BP solver of the correctness check: tol 1e-6 (production 1e-3, at which
# envelope forces legitimately differ by about tol).  Damping shapes the
# convergence path, never the fixed point; the production 0.1 stalls at
# the float32 noise floor (~2e-6 belief change) and reaches 1e-6 only by
# chance, the reference's 0.4 converges to 1e-6 in a few dozen sweeps.
CHECK_TOL = 1e-6
CHECK_DAMPING = 0.4
ENERGY_RTOL = 1e-4      # per-term contract of BASELINE.md
NODE_TOL = 1e-4         # relative where |E| > 1, else absolute
FORCE_RMS_RTOL = 1e-3
N_REPLICA = 64
N_ROUNDS = 20
# MD schedule, in advances of N_ROUNDS rounds.  The built chain starts
# far from equilibrium (its potential falls from about 830 to 240 in the
# first 500 rounds), and the heat it gives off outruns the thermostat
# (timescale 5, about 185 rounds): left alone, replicas run at up to
# twice the temperature for rounds 40-100.  So the first N_EQUILIBRATE
# advances each end with fresh Maxwell-Boltzmann momenta at the target
# temperature, and the kinetic energy is judged after N_PRODUCTION more
# advances under the thermostat alone.
N_EQUILIBRATE = 15
N_PRODUCTION = 10


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def device_check(n_devices):
    """Phase 1: a GPU backend with at least n_devices cards."""
    backend = jax.default_backend()
    check(backend == "gpu", f"JAX backend is {backend!r}, not 'gpu'")
    devs = jax.devices()
    print(f"device_kind: {devs[0].device_kind}  device_count: {len(devs)}")
    check(len(devs) >= n_devices,
          f"need {n_devices} GPUs, JAX sees {len(devs)}")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    cards = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    for ln in cards[:n_devices]:
        print(ln)
    return devs, cards[0]


def build_flagship():
    """Phase 2: seeded full-forcefield ubiquitin, built in memory."""
    from upside_md.bench_systems import (UBIQUITIN, build_full_system,
                                         seeded_libraries)
    sidechain, environment = seeded_libraries()
    system, params, pos, _ = build_full_system(
        seq=UBIQUITIN, sidechain_lib=sidechain, environment_lib=environment)
    names = {s.node_type.name for s in system.specs}
    print(f"system: ubiquitin {len(UBIQUITIN)} residues, "
          f"{len(system.specs)} nodes: {sorted(names)}")
    for need in ("rotamer", "protein_hbond", "environment_coverage"):
        check(need in names, f"flagship lacks the {need} node")
    return system, params, pos, (sidechain, environment)


def with_check_solver(system):
    """The same graph with every rotamer node's BP solve set to the
    correctness check's tolerance and damping."""
    import dataclasses

    from upside_md.system import System
    specs = [dataclasses.replace(s, consts={**s.consts, "tol": CHECK_TOL,
                                            "damping": CHECK_DAMPING})
             if s.node_type.name == "rotamer" else s for s in system.specs]
    return System(system.n_atom, specs)


def correctness(system, params, pos):
    """Phase 3: GPU against the CPU backend of this process."""
    tight = with_check_solver(system)
    rng = np.random.default_rng(0)
    pos2 = np.stack([pos, pos]) + 0.02 * rng.normal(size=(2,) + pos.shape)
    pos2 = pos2.astype(np.float32)

    def eval_one(p, prm):
        def total(q):
            e, _, per_term = tight.evaluate(q, prm)
            return e, per_term
        (e, per_term), g = jax.value_and_grad(total, has_aux=True)(p)
        _, cache = tight.energy_and_cache(p, prm)
        return e, per_term, g, cache

    def run(device, precision):
        with jax.default_matmul_precision(precision):
            fn = jax.jit(jax.vmap(eval_one, in_axes=(0, None)))
            args = jax.device_put((jnp.asarray(pos2), params), device)
            return jax.tree.map(np.asarray, fn(*args))

    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    ref = run(cpu, "highest")
    print(f"cpu reference: {time.perf_counter() - t0:.1f} s")
    results = {}
    for precision in ("default", "highest"):
        t0 = time.perf_counter()
        results[precision] = run(gpu, precision)
        print(f"gpu {precision}: {time.perf_counter() - t0:.1f} s "
              f"(compile included)")

    e_ref, per_ref, g_ref, _ = ref
    failures = []
    for precision, (e, per, g, cache) in results.items():
        err = float(np.max(np.abs(e - e_ref) / np.abs(e_ref)))
        print(f"[{precision}] total energy rel err {err:.3e} "
              f"(bound {ENERGY_RTOL:.0e}); E = {e.tolist()}")
        if not err <= ENERGY_RTOL:
            failures.append(f"{precision} total energy")
        for name in sorted(per_ref):
            a, b = per[name], per_ref[name]
            if np.max(np.abs(b)) > 1.0:
                err = float(np.max(np.abs(a - b) / np.abs(b)))
                kind = "rel"
            else:
                err = float(np.max(np.abs(a - b)))
                kind = "abs"
            print(f"[{precision}]   {name:34s} {kind} err {err:.3e} "
                  f"(bound {NODE_TOL:.0e}); E = {b.tolist()}")
            if not err <= NODE_TOL:
                failures.append(f"{precision} node {name}")
        rms = float(np.sqrt(np.mean((g - g_ref) ** 2))
                    / np.sqrt(np.mean(g_ref ** 2)))
        print(f"[{precision}] force RMS rel err {rms:.3e} "
              f"(bound {FORCE_RMS_RTOL:.0e})")
        if not rms <= FORCE_RMS_RTOL:
            failures.append(f"{precision} forces")
        for name, entry in cache.items():
            rot = tight.by_name[name]
            max_iter = int(rot.consts["max_iter"])
            dev, sweeps = np.asarray(entry.deviation), np.asarray(entry.sweeps)
            print(f"[{precision}] {name} BP check solve: sweeps "
                  f"{sweeps.tolist()} (max_iter {max_iter}), final "
                  f"deviation {dev.tolist()} (tol {CHECK_TOL:.0e})")
            if not (np.all(sweeps < max_iter) and np.all(dev <= CHECK_TOL)):
                failures.append(f"{precision} BP convergence")
    check(not failures, f"correctness bounds missed: {failures}")


def md(system, params, pos, card):
    """Phase 4: 64 replicas of MD with warm-started BP caches."""
    from upside_md.md.sim import Simulation
    from upside_md.md.thermostat import thermalize
    from upside_md.nodes.rotamer import bp_solve_health
    temperature = 0.85
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     do_recenter=False)
    state = sim.initial_state(pos, params, seed=1, temperature=temperature,
                              n_replica=N_REPLICA)
    t0 = time.perf_counter()
    state = jax.block_until_ready(sim.advance(state, params, N_ROUNDS, True))
    print(f"md compile + first {N_ROUNDS} rounds: "
          f"{time.perf_counter() - t0:.1f} s")
    for i in range(N_EQUILIBRATE):
        if i:
            state = sim.advance(state, params, N_ROUNDS, True)
        key = jax.random.fold_in(jax.random.PRNGKey(1), i)
        state = state._replace(mom=thermalize(
            key, state.mom.shape, temperature, state.mom.dtype))
    state = jax.block_until_ready(state)
    print(f"md: equilibrated {N_EQUILIBRATE * N_ROUNDS} rounds, momenta "
          f"redrawn every {N_ROUNDS}")
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        state = jax.block_until_ready(
            sim.advance(state, params, N_ROUNDS, True))
        times.append(time.perf_counter() - t0)
    steps = 3 * N_ROUNDS * N_REPLICA
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"md: {N_REPLICA} replicas x {N_ROUNDS} rounds: "
          f"{[round(t, 4) for t in times]} s, "
          f"{steps / min(times):.1f} steps/s (force evaluations); "
          f"peak_bytes_in_use {peak}; card {card}")
    for _ in range(N_PRODUCTION - 2):
        state = sim.advance(state, params, N_ROUNDS, True)
    n_done = int(np.asarray(state.round_num)[0])
    pos_np = np.asarray(state.pos)
    check(np.all(np.isfinite(pos_np)), "non-finite positions after MD")
    ratio = np.asarray(sim.kinetic_energy(state)) / (1.5 * temperature)
    print(f"md: after {n_done} rounds kinetic energy / 1.5kT: "
          f"min {ratio.min():.3f} mean {ratio.mean():.3f} "
          f"max {ratio.max():.3f}")
    check(np.all((ratio > 0.5) & (ratio < 2.0)),
          "kinetic energy off 1.5 kT by more than a factor of 2")
    for name, entry in state.cache.items():
        dev, sweeps = bp_solve_health(entry)
        tol = float(system.by_name[name].consts["tol"])
        print(f"md: {name} last solve: bad solves "
              f"{int((dev > tol).sum())}/{len(dev)}, sweeps mean "
              f"{sweeps.mean():.2f} max {sweeps.max()}")


def cli_phase(libraries):
    """Phase 5: the `upside` CLI in process on .up files."""
    try:
        import h5py
    except ImportError:
        print("cli_phase: not run, h5py is not installed")
        return
    from upside_md import cli
    from upside_md.bench_systems import UBIQUITIN, full_builder
    sidechain, environment = libraries
    os.makedirs(SCRATCH, exist_ok=True)
    temps = [0.80, 0.85, 0.90, 0.95]
    paths = [full_builder(UBIQUITIN, sidechain_lib=sidechain,
                          environment_lib=environment).write(
                              os.path.join(SCRATCH, f"smoke_{i}.up"))
             for i in range(len(temps))]
    t0 = time.perf_counter()
    rc = cli.main(["--duration", "1.08", "--frame-interval", "0.27",
                   "--replica-interval", "0.27",
                   "--temperature", ",".join(map(str, temps)),
                   "--swap-set", "0-1,2-3", "--swap-set", "1-2",
                   "--seed", "7"] + paths)
    check(rc == 0, f"cli returned {rc}")
    print(f"cli: {time.perf_counter() - t0:.1f} s (compile included)")
    for path in paths:
        with h5py.File(path, "r") as f:
            out = f["output"]
            pos = np.asarray(out["pos"])
            names = sorted(out)
        check(pos.shape[0] == 4 and np.all(np.isfinite(pos)),
              f"{path}: trajectory {pos.shape}, finite "
              f"{bool(np.all(np.isfinite(pos)))}")
        check(any(n.endswith("_n_bad_solve") for n in names)
              and "replica_index" in names,
              f"{path}: missing streams in {names}")
    print(f"cli: {len(paths)} trajectories of {pos.shape[0]} frames read "
          f"back; streams {names}")


def mesh_phase(n_devices, system, params, pos):
    """--devices N: the replica mesh across N GPUs against one GPU."""
    from upside_md.md.replica import ReplicaExchange, even_odd_swap_sets
    from upside_md.md.sim import Simulation, stack_param_ensembles
    from upside_md.parallel.mesh import (collectives_in, make_replica_mesh,
                                         shard_replica_state,
                                         sharded_advance,
                                         sharded_hamiltonian_advance,
                                         sharded_training_step)
    n_rep, n_rounds = 16, 3
    mesh = make_replica_mesh(n_devices)
    sim = Simulation(system, dt=0.009, thermostat_interval=0.027,
                     do_recenter=False)
    temps = 0.8 + 0.02 * np.arange(n_rep)
    state = sim.initial_state(pos, params, seed=3, temperature=temps,
                              n_replica=n_rep)

    advance = sharded_advance(sim, mesh, n_rounds)
    t0 = time.perf_counter()
    out = jax.block_until_ready(advance(state, params))
    print(f"mesh: sharded advance over {n_devices} GPUs: "
          f"{time.perf_counter() - t0:.1f} s (compile included)")
    one = jax.device_put(state, jax.devices()[0])
    t0 = time.perf_counter()
    ref = jax.block_until_ready(sim.advance(one, params, n_rounds, True))
    print(f"mesh: same state on GPU 0 alone: "
          f"{time.perf_counter() - t0:.1f} s (compile included)")
    for label, fn in (("sharded", lambda: advance(state, params)),
                      ("one GPU", lambda: sim.advance(one, params,
                                                      n_rounds, True))):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        dt = time.perf_counter() - t0
        print(f"mesh: {label} advance {n_rep} replicas x {n_rounds} "
              f"rounds: {dt:.4f} s, {3 * n_rounds * n_rep / dt:.1f} steps/s")
    # Replicas share nothing, but under vmap every BP solve sweeps until
    # the slowest replica of its batch converges: 4 replicas per GPU on
    # the mesh, 16 on one GPU.  Beliefs then differ by up to the BP tol,
    # the forces by about tol times their scale, and positions after a
    # few rounds by far less than tol (in Angstrom).
    tol = float([s for s in system.specs
                 if s.node_type.name == "rotamer"][0].consts["tol"])
    dpos = float(np.max(np.abs(np.asarray(out.pos) - np.asarray(ref.pos))))
    print(f"mesh: max |pos(sharded) - pos(one GPU)| = {dpos:.3e} A "
          f"(bound BP tol = {tol:.0e})")
    check(np.all(np.isfinite(np.asarray(out.pos))), "non-finite positions")
    check(dpos <= tol, "sharded advance departs from the one-GPU run")

    rex = ReplicaExchange(even_odd_swap_sets(n_rep), n_rep)
    energy_of = jax.jit(jax.vmap(lambda p: system.energy(p, params)))
    beta = jnp.asarray(1.0 / temps, jnp.float32)
    new_pos, idx, stats, _ = rex.attempt_swaps(
        jax.random.PRNGKey(0), out.pos, jnp.arange(n_rep), beta,
        energy_of, slot_independent=True)
    idx = np.asarray(idx)
    check(sorted(idx.tolist()) == list(range(n_rep)),
          "swap did not permute the replicas")
    n_acc = int(sum(np.asarray(s)[:, 0].sum() for s in stats))
    print(f"mesh: replica exchange across the mesh: {n_acc} swaps "
          f"accepted, replica order {idx.tolist()}")

    def sgd(p, g, s):
        return jax.tree.map(lambda a, b: a - 1e-6 * b, p, g), s

    step = sharded_training_step(system, sgd, mesh)
    _, _, loss = step(params, (), new_pos, jnp.zeros((n_rep,), jnp.float32))
    check(np.isfinite(float(loss)), "training loss not finite")
    print(f"mesh: psum training step loss {float(loss):.6e}")

    spring = [k for k in params if "spring_const" in params[k]][0]
    per_slot = []
    for i in range(n_rep):
        p = {k: dict(v) for k, v in params.items()}
        p[spring]["spring_const"] = params[spring]["spring_const"] * \
            (1.0 + 0.01 * i)
        per_slot.append(p)
    mixed, spec = stack_param_ensembles(per_slot)
    h_state = sim.initial_state(pos, mixed, seed=7, temperature=temps,
                                n_replica=n_rep)
    h_advance, h_params = sharded_hamiltonian_advance(sim, mesh, n_rounds,
                                                      mixed, spec)
    h_out = jax.block_until_ready(h_advance(h_state))
    check(np.all(np.isfinite(np.asarray(h_out.pos))),
          "Hamiltonian advance: non-finite positions")
    print(f"mesh: Hamiltonian advance, stacked leaves {sorted(spec)}")

    # replicas share nothing between swaps: neither compiled sharded
    # advance may hold a cross-device collective
    found = {
        "sharded advance": collectives_in(advance.compiled.lower(
            shard_replica_state(state, mesh), params).compile().as_text()),
        "sharded Hamiltonian advance": collectives_in(
            h_advance.compiled.lower(shard_replica_state(h_state, mesh),
                                     h_params).compile().as_text()),
    }
    print(f"mesh: collective audit: {found}")
    check(not any(found.values()), "cross-device collectives in advance")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="run the replica mesh across this many GPUs "
                         "(and no other phase)")
    args = ap.parse_args(argv)
    try:
        devs, card = device_check(args.devices)
        sys.path.insert(0, HERE)
        from upside_md.compile_cache import enable_compile_cache
        print(f"compile cache: {enable_compile_cache()}")
        system, params, pos, libraries = build_flagship()
        if args.devices > 1:
            mesh_phase(args.devices, system, params, pos)
            count = args.devices
        else:
            correctness(system, params, pos)
            md(system, params, pos, card)
            cli_phase(libraries)
            count = len(devs)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
