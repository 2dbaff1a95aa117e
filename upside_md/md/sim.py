"""Simulation driver: the reference main-loop (src/main.cpp:616-673) as a
single jitted round function.

One round = optional MC moves, optional thermostat (with annealing),
then a 3-stage integration cycle.  `advance` runs N rounds inside a
lax.fori_loop; the host only intervenes at frame boundaries (logging,
recentering, replica exchange), so the device sees long fused chains of
force evaluations.  With a replica ensemble the whole round function is
vmapped over the leading axis — the analog of the reference's
one-OpenMP-thread-per-replica — and shard_map distributes that axis over
a device mesh.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .integrator import integration_cycle, recenter
from .mc import JumpSampler, PivotSampler, metropolis_step
from .thermostat import (JUMP_MOVE_STREAM, PIVOT_MOVE_STREAM,
                         THERMOSTAT_STREAM, OUThermostat, stream_key,
                         thermalize)


def stack_param_ensembles(param_list):
    """Combine per-slot parameter pytrees for a Hamiltonian ensemble.

    Only leaves that actually DIFFER across slots are stacked along a new
    replica axis; identical leaves stay shared, so a Hamiltonian ladder
    that varies, say, a spring constant keeps one copy of the sidechain
    tables instead of one per slot.

    Returns (params, spec): spec is a frozenset of jax.tree_util.keystr
    key paths of the stacked leaves — hashable, so it can ride through
    jit static arguments (Simulation.advance params_batched) — and
    param_axes(params, spec) rebuilds the vmap in_axes tree."""
    first = param_list[0]
    treedef = jax.tree_util.tree_structure(first)
    for i, p in enumerate(param_list[1:], 1):
        if jax.tree_util.tree_structure(p) != treedef:
            raise ValueError(
                f"Hamiltonian ensemble slot {i} has a different parameter "
                f"tree structure than slot 0 — every config must define "
                f"the same potentials")
    paths = [jax.tree_util.keystr(kp) for kp, _ in
             jax.tree_util.tree_flatten_with_path(first)[0]]
    leaf_lists = list(zip(*[jax.tree_util.tree_leaves(p)
                            for p in param_list]))
    spec = frozenset(
        path for path, leaves in zip(paths, leaf_lists)
        if not all(np.array_equal(np.asarray(leaves[0]), np.asarray(x))
                   for x in leaves[1:]))
    combined = jax.tree_util.tree_unflatten(treedef, [
        jnp.stack(leaves) if path in spec else leaves[0]
        for path, leaves in zip(paths, leaf_lists)])
    return combined, spec


def param_axes(params, spec):
    """vmap in_axes pytree for params combined by stack_param_ensembles:
    0 at stacked leaves, None at shared ones.  spec=True means fully
    stacked (axis 0 everywhere); False/empty means fully shared."""
    if spec is True:
        return 0
    if not spec:
        return None
    return jax.tree_util.tree_map_with_path(
        lambda kp, x: 0 if jax.tree_util.keystr(kp) in spec else None,
        params)


class SimState(NamedTuple):
    pos: jnp.ndarray            # (n_atom, 3) [+ leading replica axis]
    mom: jnp.ndarray
    round_num: jnp.ndarray      # int32
    seed: jnp.ndarray           # int32 per replica
    temperature: jnp.ndarray
    initial_temperature: jnp.ndarray
    pivot_stats: jnp.ndarray    # (2,) int32 [success, attempt]
    jump_stats: jnp.ndarray
    # per-node solver state (System.energy_and_cache): warm-start data
    # such as BP messages, threaded through every force evaluation
    cache: dict = {}


class Simulation:
    def __init__(self, system, dt=0.009, duration=None,
                 thermostat_timescale=5.0, thermostat_interval=None,
                 frame_interval=None, mc_interval=None,
                 integrator="verlet", max_force=0.0,
                 pivot_sampler: Optional[PivotSampler] = None,
                 jump_sampler: Optional[JumpSampler] = None,
                 anneal_factor=1.0, anneal_duration=None,
                 do_recenter=True, xy_recenter_only=False):
        """Intervals are in simulation-time units and convert to integer
        rounds of 3*dt exactly as the reference CLI does
        (main.cpp:397-411)."""
        self.system = system
        self.dt = float(dt)
        round_time = 3.0 * self.dt
        self.n_round = int(round(duration / round_time)) if duration else 0
        self.thermostat_interval = max(
            1, int(round((thermostat_interval or round_time) / round_time)))
        self.frame_interval = max(
            1, int(round((frame_interval or round_time) / round_time)))
        self.mc_interval = (max(1, int(mc_interval / round_time))
                            if mc_interval else 0)
        self.integrator = integrator
        self.max_force = max_force
        self.pivot_sampler = pivot_sampler
        self.jump_sampler = jump_sampler
        self.thermostat = OUThermostat(
            thermostat_timescale, self.thermostat_interval * round_time)
        self.anneal_factor = float(anneal_factor)
        self.duration = duration or 0.0
        self.anneal_duration = (anneal_duration if anneal_duration
                                else self.duration)
        self.do_recenter = do_recenter
        self.xy_recenter_only = xy_recenter_only

    # -- setup --------------------------------------------------------------

    def initial_state(self, pos, params, seed=42, temperature=1.0,
                      n_replica=None):
        pos = jnp.asarray(pos)
        if n_replica is not None and pos.ndim == 2:
            pos = jnp.broadcast_to(pos, (n_replica,) + pos.shape)
        batched = pos.ndim == 3
        n_rep = pos.shape[0] if batched else 1
        seeds = np.uint32(seed) + np.arange(n_rep, dtype=np.uint32)
        temps = jnp.broadcast_to(
            jnp.asarray(temperature, pos.dtype).reshape(-1), (n_rep,))

        cache0 = self.system.init_cache()

        def make_one(p, s, t):
            key = stream_key(int(s), THERMOSTAT_STREAM, 0)
            mom = thermalize(key, p.shape, t, p.dtype)
            return SimState(
                pos=p, mom=mom,
                round_num=jnp.asarray(0, jnp.int32),
                seed=jnp.asarray(s, jnp.uint32),
                temperature=jnp.asarray(t, p.dtype),
                initial_temperature=jnp.asarray(t, p.dtype),
                pivot_stats=jnp.zeros(2, jnp.int32),
                jump_stats=jnp.zeros(2, jnp.int32),
                cache=cache0)

        if batched:
            states = [make_one(pos[i], seeds[i], temps[i])
                      for i in range(n_rep)]
            return jax.tree.map(lambda *xs: jnp.stack(xs), *states)
        return make_one(pos, seeds[0], temps[0])

    # -- one round ----------------------------------------------------------

    def _anneal_temperature(self, t0, round_num):
        """sqrt-T-space annealing schedule (main.cpp:437-443)."""
        if self.anneal_factor == 1.0:
            return t0
        time = 3.0 * self.dt * (round_num + 1.0)
        anneal_start = self.duration - self.anneal_duration
        frac = jnp.clip((time - anneal_start) /
                        max(self.anneal_duration, 1e-10), 0.0, 1.0)
        s = jnp.sqrt(t0) * (1.0 - frac) + \
            jnp.sqrt(t0 * self.anneal_factor) * frac
        return s * s

    def _one_round(self, state: SimState, params, nr) -> SimState:
        # `nr` (the round number) arrives as an UNBATCHED scalar from
        # `advance`, NOT from the vmapped state: the round counter is
        # global across replicas, and keeping the lax.cond predicates
        # below unbatched keeps them true conditionals.  A batched
        # predicate would evaluate both branches and select.

        def energy(p):
            return self.system.energy(p, params)

        def deriv(p, stage, cache):
            extra = {"n_deriv_evals": 3 * nr + stage + 1}
            g, new_cache = jax.grad(
                lambda q: self.system.energy_and_cache(
                    q, params, extra=extra, cache=cache),
                has_aux=True)(p)
            return g, new_cache

        # Monte Carlo moves (not at round 0, main.cpp:628-631)
        if self.mc_interval:
            def do_mc(st):
                pos, pstats, jstats = st.pos, st.pivot_stats, st.jump_stats
                if self.pivot_sampler is not None:
                    key = stream_key(st.seed, PIVOT_MOVE_STREAM, nr)
                    pos, acc = metropolis_step(key, pos, st.temperature,
                                               energy, self.pivot_sampler)
                    pstats = pstats + jnp.array([0, 1], jnp.int32).at[0].set(
                        acc.astype(jnp.int32))
                if self.jump_sampler is not None:
                    key = stream_key(st.seed, JUMP_MOVE_STREAM, nr)
                    pos, acc = metropolis_step(key, pos, st.temperature,
                                               energy, self.jump_sampler)
                    jstats = jstats + jnp.array([0, 1], jnp.int32).at[0].set(
                        acc.astype(jnp.int32))
                return st._replace(pos=pos, pivot_stats=pstats,
                                   jump_stats=jstats)

            state = jax.lax.cond(
                (nr > 0) & (nr % self.mc_interval == 0), do_mc,
                lambda st: st, state)

        # thermostat + annealing (main.cpp:657-662)
        def do_thermostat(st):
            temp = self._anneal_temperature(st.initial_temperature, nr)
            key = stream_key(st.seed, THERMOSTAT_STREAM, nr + 1)
            mom = self.thermostat.apply(key, st.mom, temp)
            return st._replace(mom=mom, temperature=temp)

        state = jax.lax.cond(nr % self.thermostat_interval == 0,
                             do_thermostat, lambda st: st, state)

        pos, mom, cache = integration_cycle(
            deriv, state.pos, state.mom, self.dt, self.max_force,
            self.integrator, cache=state.cache)
        return state._replace(pos=pos, mom=mom, round_num=nr + 1,
                              cache=cache)

    # -- bulk advancement ---------------------------------------------------

    @functools.partial(jax.jit, static_argnums=(0, 3, 4, 5))
    def advance(self, state, params, n_rounds, batched=False,
                params_batched=False):
        """Run n_rounds rounds on device.  batched=True vmaps over the
        leading replica axis of the state; params_batched additionally
        gives every replica slot its own parameter pytree (Hamiltonian
        replica exchange — the reference's per-system engines,
        main.cpp:456-495): True for fully stacked params, or a
        stack_param_ensembles spec (frozenset of stacked leaf paths) so
        shared tables stay unbatched."""
        base = (state.round_num[0] if batched else state.round_num)

        def body(i, st):
            nr = base + i    # unbatched scalar round number (see _one_round)
            if batched and params_batched:
                axes = param_axes(params, params_batched)
                return jax.vmap(
                    lambda s, p: self._one_round(s, p, nr),
                    in_axes=(0, axes))(st, params)
            if batched:
                return jax.vmap(
                    lambda s: self._one_round(s, params, nr))(st)
            return self._one_round(st, params, nr)
        return jax.lax.fori_loop(0, n_rounds, body, state)

    # -- observables --------------------------------------------------------

    def kinetic_energy(self, state):
        """(1/2)<|p|^2> per atom (main.cpp:532-536)."""
        return 0.5 * jnp.mean(jnp.sum(state.mom ** 2, -1), -1)

    def potential_energy(self, state, params, batched=False,
                         params_batched=False):
        if batched and params_batched:
            return jax.vmap(
                self.system.energy,
                in_axes=(0, param_axes(params, params_batched)))(
                state.pos, params)
        f = lambda p: self.system.energy(p, params)  # noqa: E731
        return jax.vmap(f)(state.pos) if batched else f(state.pos)

    def recentered(self, state):
        return state._replace(
            pos=recenter(state.pos, self.xy_recenter_only))

    # -- host-side run loop -------------------------------------------------

    def run(self, state, params, n_round=None, frame_callback=None,
            batched=False):
        """Frame-chunked main loop; the device runs frame_interval rounds
        per dispatch and the host logs in between."""
        n_round = n_round if n_round is not None else self.n_round
        while int(state.round_num if not batched else state.round_num[0]) \
                < n_round:
            done = int(state.round_num if not batched
                       else state.round_num[0])
            chunk = min(self.frame_interval, n_round - done)
            state = self.advance(state, params, chunk, batched)
            if self.do_recenter:
                state = self.recentered(state)
            if frame_callback is not None:
                frame_callback(state)
        return state
