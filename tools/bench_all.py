"""Benchmark configurations and the single-device replica curve, in one
run on the GPU.

Prints one row per configuration:
  1. backbone-only ubiquitin and Trp-cage, and full-FF Trp-cage
  2. full-FF ubiquitin at 8 to 1024 replicas: the single-device replica
     curve, to find where aggregate throughput stops rising
  3. protein-G with the 10A-cutoff parameter family
  4. 64-replica temperature and Hamiltonian replica exchange, swaps
     included
  5. chi1-prediction latency: one energy eval + marginal readout
     (reference predict_chi1.py:103-113 semantics)
  6. the training step

Full-FF systems use the seeded libraries unless UPSIDE_PARAM_DIR names
the reference's.  Every timed call ends in jax.block_until_ready.

Usage:  python tools/bench_all.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from upside_md.bench_systems import (PROTEIN_G, TRP_CAGE, UBIQUITIN,
                                     build_10A_system,
                                     build_backbone_system,
                                     build_full_system, seeded_libraries)
from upside_md.compile_cache import enable_compile_cache
from upside_md.md.replica import ReplicaExchange, even_odd_swap_sets
from upside_md.md.sim import Simulation
from upside_md.md.thermostat import REPLICA_EXCHANGE_STREAM, stream_key


def timed(fn, n=3):
    """Median wall time of fn(), which returns the arrays to wait for."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def md_steps_per_sec(system, params, pos, n_replica, n_rounds=20,
                     seed=None):
    seed = seed if seed is not None else int(time.time()) % 100000
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     do_recenter=False)
    state = [sim.initial_state(pos, params, seed=seed, temperature=0.85,
                               n_replica=n_replica)]

    def step():
        state[0] = sim.advance(state[0], params, n_rounds, True)
        return state[0].pos

    t = timed(step)
    return 3 * n_rounds * n_replica / t


def rex_steps_per_sec(system, params, pos, n_replica=64, n_rounds_total=60,
                      rex_every=10):
    """End-to-end temperature replica exchange: MD rounds + swap rounds
    (one ensemble energy evaluation per exchange round; swapped-state
    energies are exact permutations for temperature-only exchange)
    included in the timing."""
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     do_recenter=False)
    temps = 0.80 * (1.02 ** np.arange(n_replica))
    state = [sim.initial_state(pos, params,
                               seed=int(time.time()) % 100000,
                               temperature=temps, n_replica=n_replica)]
    rex = ReplicaExchange(even_odd_swap_sets(n_replica), n_replica)
    energy_of = jax.jit(jax.vmap(lambda p: system.energy(p, params)))
    beta = jnp.asarray(1.0 / temps, jnp.float32)
    ridx = [jnp.arange(n_replica)]
    stats = [None]
    round_done = [0]

    def chunk():
        for _ in range(n_rounds_total // rex_every):
            state[0] = sim.advance(state[0], params, rex_every, True)
            key = stream_key(1234, REPLICA_EXCHANGE_STREAM, round_done[0])
            new_pos, ridx[0], stats[0], _, ncache = rex.attempt_swaps(
                key, state[0].pos, ridx[0], beta, energy_of, stats[0],
                slot_independent=True, aux=state[0].cache)
            state[0] = state[0]._replace(pos=new_pos, cache=ncache)
            round_done[0] += rex_every
        return state[0].pos

    t = timed(chunk)
    acc = [np.asarray(s) for s in stats[0]]
    rate = (sum(a[:, 0].sum() for a in acc)
            / max(sum(a[:, 1].sum() for a in acc), 1))
    return 3 * n_rounds_total * n_replica / t, float(rate)


def hamiltonian_rex_steps_per_sec(n_replica=64, n_rounds_total=60,
                                  rex_every=10):
    """64-replica HAMILTONIAN replica exchange on the 104-res cytochrome
    c, full forcefield.  Each slot carries its own parameter pytree (a
    2%-wide ladder, ±1%, on the backbone spring constants); only the
    varied leaf is stacked (stack_param_ensembles), so the shared
    sidechain tables stay unbatched.
    Swapped-configuration energies are re-evaluated per swap set (the
    slots' Hamiltonians differ), exactly as the reference's per-system
    engines do (main.cpp:251-274)."""
    from upside_md.bench_systems import CYT_C
    from upside_md.md.sim import param_axes, stack_param_ensembles

    system, params, pos, _ = build_full_system(seq=CYT_C)
    pos = jnp.asarray(pos)

    spring_keys = [k for k in params if "spring" in k
                   and "spring_const" in params[k]]
    vary = spring_keys[0]
    per_slot = []
    for i in range(n_replica):
        p = jax.tree.map(lambda x: x, params)
        p[vary] = dict(p[vary])
        p[vary]["spring_const"] = params[vary]["spring_const"] * \
            (1.0 + 0.02 * (i / max(n_replica - 1, 1) - 0.5))
        per_slot.append(p)
    mixed, spec = stack_param_ensembles(per_slot)

    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     do_recenter=False)
    temps = 0.80 * (1.02 ** np.arange(n_replica))
    state = [sim.initial_state(pos, mixed,
                               seed=int(time.time()) % 100000,
                               temperature=temps, n_replica=n_replica)]
    rex = ReplicaExchange(even_odd_swap_sets(n_replica), n_replica)
    axes = param_axes(mixed, spec)
    energy_of = jax.jit(lambda pp: jax.vmap(
        system.energy, in_axes=(0, axes))(pp, mixed))
    beta = jnp.asarray(1.0 / temps, jnp.float32)
    ridx = [jnp.arange(n_replica)]
    stats = [None]
    round_done = [0]

    def chunk():
        for _ in range(n_rounds_total // rex_every):
            state[0] = sim.advance(state[0], mixed, rex_every, True, spec)
            key = stream_key(1234, REPLICA_EXCHANGE_STREAM, round_done[0])
            new_pos, ridx[0], stats[0], _, ncache = rex.attempt_swaps(
                key, state[0].pos, ridx[0], beta, energy_of, stats[0],
                aux=state[0].cache)
            state[0] = state[0]._replace(pos=new_pos, cache=ncache)
            round_done[0] += rex_every
        return state[0].pos

    t = timed(chunk)
    acc = [np.asarray(s) for s in stats[0]]
    rate = (sum(a[:, 0].sum() for a in acc)
            / max(sum(a[:, 1].sum() for a in acc), 1))
    return 3 * n_rounds_total * n_replica / t, float(rate)


def chi1_latency():
    """Single energy eval + hbond_coverage sensitivity readout (the
    paper's evaluation-time metric)."""
    from upside_md.bench_systems import SIDECHAIN, have_reference_params
    from upside_md.config.builder import ConfigBuilder
    from upside_md.config.reader import load_system

    lib = (SIDECHAIN if have_reference_params() else seeded_libraries()[0])
    b = ConfigBuilder(f">x\n{UBIQUITIN}\n", seed=7)
    b.add_rotamer_sidechains(lib, lib, damping=0.4, dynamic_1body=True)
    b.add_hbond(hbond_energy=-1e-5, loose=True, coverage_library=lib)
    b.add_rotamer_node()
    system, params, pos, aux = load_system(b.to_group())
    pos = jnp.asarray(pos)

    sens_fn = jax.jit(lambda p: system.get_sens(p, params, 'hbond_coverage'))
    t_total = timed(lambda: sens_fn(pos), n=5)

    # Device compute apart from per-call dispatch: chain K evals inside
    # one jit; each iteration perturbs the position by a value derived
    # from the previous output so no eval can be cached or elided.  The
    # reference's paper metric is seconds of pure compute
    # (predict_chi1.py:103-113) — t_dev is the comparable number.
    K = 30

    @jax.jit
    def chained(p):
        def body(_, carry):
            p, acc = carry
            s = system.get_sens(p, params, 'hbond_coverage')
            return p + 1e-9 * jnp.sum(s) * jnp.sign(p), acc + jnp.sum(s)
        return jax.lax.fori_loop(0, K, body, (p, 0.0))[1]

    t_dev = timed(lambda: chained(pos), n=3) / K
    return t_dev, t_total


def training_throughput(n_replica=64, K=10):
    """Differentiable-training step throughput — energy-match loss over a
    replica batch of perturbed ubiquitin conformations, FULL parameter
    gradients (incl. the interaction-table cotangent paths the MD loop
    never runs), SGD update, on one device.  Reference path: tensorflow_upside.py:148-295
    (energy/deriv custom op inside the TF graph).  Returns
    (t_dev_per_step, t_total_one_shot)."""
    from upside_md.parallel.mesh import (make_replica_mesh,
                                             sharded_training_step)
    system, params, pos, _ = build_full_system(seq=UBIQUITIN)
    pos = jnp.asarray(pos)
    rng = np.random.default_rng(0)
    batch = jnp.asarray(
        np.asarray(pos)[None]
        + 0.02 * rng.standard_normal((n_replica,) + pos.shape),
        pos.dtype)
    target = jnp.zeros((n_replica,), pos.dtype)
    mesh = make_replica_mesh(1)

    def sgd(p, g, s):
        return jax.tree.map(lambda a, b: a - 1e-6 * b, p, g), s

    step = sharded_training_step(system, sgd, mesh)
    t_total = timed(lambda: step(params, (), batch, target)[2], n=3)

    # device time: chain K steps in one jit (params evolve through the
    # SGD update each iteration, so no step can be cached or DCE'd)
    @jax.jit
    def chained(p):
        def body(_, carry):
            p, acc = carry
            p2, _, loss = step(p, (), batch, target)
            return p2, acc + loss
        return jax.lax.fori_loop(0, K, body, (p, 0.0))[1]

    t_dev = timed(lambda: chained(params), n=3) / K
    return t_dev, t_total


def main():
    # fault isolation: one failing config must not lose the whole table;
    # rows print as they complete.
    import traceback

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU: JAX found {dev.platform}")
    print(f"device: {dev.device_kind} x{len(jax.devices())}")

    def row(name, fn):
        try:
            v = fn()
            print(f"{name:55s} {v:12,.0f} steps/s", flush=True)
        except Exception:
            print(f"{name:55s}        ERROR", flush=True)
            traceback.print_exc()

    sysb, pb, posb, _ = build_backbone_system(seq=UBIQUITIN)
    row("backbone-only 76-res ubiquitin, 64 rep",
        lambda: md_steps_per_sec(sysb, pb, posb, 64))
    sysb, pb, posb, _ = build_backbone_system(seq=TRP_CAGE)
    row("backbone-only 20-res Trp-cage, 64 rep",
        lambda: md_steps_per_sec(sysb, pb, posb, 64))

    sysf, pf, posf, _ = build_full_system(seq=TRP_CAGE)
    row("full FF 20-res Trp-cage, 64 rep",
        lambda: md_steps_per_sec(sysf, pf, posf, 64))

    sysg, pg, posg, _ = build_10A_system(seq=PROTEIN_G)
    row("full FF 56-res protein-G (10A family), 64 rep",
        lambda: md_steps_per_sec(sysg, pg, posg, 64))

    sysu, pu, posu, _ = build_full_system(seq=UBIQUITIN)
    for n in (8, 32, 64, 128, 256, 384, 512, 768, 1024):
        row(f"full FF 76-res ubiquitin, {n} rep",
            lambda n=n: md_steps_per_sec(sysu, pu, posu, n))

    def trex():
        sps, acc = rex_steps_per_sec(sysu, pu, posu, 64)
        print(f"    (T-rex acceptance {acc:.2f})")
        return sps
    row("full FF ubiquitin 64-replica T-rex incl. swaps", trex)

    def hrex():
        sps, acc = hamiltonian_rex_steps_per_sec(64)
        print(f"    (H-rex acceptance {acc:.2f})")
        return sps
    row("full FF 104-res cyt-c 64-replica H-rex incl. swaps", hrex)

    try:
        t_dev, t_total = chi1_latency()
        print(f"{'chi1 prediction latency (76-res, eval+marginals)':55s} "
              f"{t_dev*1e3:10.2f} ms device compute "
              f"({t_total*1e3:.2f} ms total one-shot)")
    except Exception:
        print("chi1 prediction latency: ERROR", flush=True)
        traceback.print_exc()

    try:
        t_dev, t_total = training_throughput()
        print(f"{'training step (energy-match, 64-rep batch, full '
              'param grads)':55s} "
              f"{t_dev*1e3:10.2f} ms device / step "
              f"({1.0/t_dev:,.1f} steps/s; one-shot {t_total*1e3:.1f} ms "
              f"incl. dispatch)")
    except Exception:
        print("training throughput: ERROR", flush=True)
        traceback.print_exc()


if __name__ == "__main__":
    main()
