"""Multi-chip scaling of replica ensembles and training.

The reference's only parallel axes are OpenMP-over-replicas for MD and
MPI-data-parallel-over-systems for training (SURVEY.md section 2.4).  On a
device mesh both become a single `replica` mesh axis:

* MD: every replica advances independently; the production advances run
  under `shard_map` (one share-nothing program per device) because plain
  jit-with-shardings lets the SPMD partitioner insert per-sweep
  all-reduces for the BP while predicate — the dryrun's zero-collective
  HLO audit fails that formulation.  Replica-exchange gathers become
  cross-device transfers, only at swap rounds.
* Training: per-system energy/parameter gradients psum over the same axis
  (replacing mpi_collective_object.py + comm.Reduce).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_replica_mesh(n_devices=None, axis="replica"):
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def shard_replica_state(state, mesh, axis="replica"):
    """Place a replica-batched SimState with its leading axis split over
    the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), state)


def sharded_advance(sim, mesh, n_rounds, axis="replica"):
    """Compile `sim.advance` with the replica axis sharded over the mesh.

    Returns advance(state, params) -> state.  Parameters are replicated;
    each device advances its local replicas — the reference's
    one-thread-per-replica OpenMP loop (main.cpp:618-667) becomes SPMD over
    the devices of the mesh.

    The body runs under shard_map, NOT plain jit-with-shardings: under
    jit the SPMD partitioner turns the BP solver's vmapped while_loop
    predicate into a cross-device pred all-reduce (every sweep would
    sync every chip and run the union of all chips' sweep counts) and
    the round-number unbatching into an s32 all-reduce.  shard_map
    traces one share-nothing program per device, so between exchange
    rounds there is zero cross-device traffic: replicas share nothing
    between swaps, as in the reference.  parallel.mesh.collectives_in
    audits the compiled program for this.
    """
    body = jax.shard_map(lambda s, p: sim.advance(s, p, n_rounds, True),
                         mesh=mesh, in_specs=(P(axis), P()),
                         out_specs=P(axis), check_vma=False)
    compiled = jax.jit(body)

    def advance(state, params):
        state = shard_replica_state(state, mesh, axis)
        return compiled(state, params)

    advance.compiled = compiled   # exposed for the collective audit
    return advance


def sharded_hamiltonian_advance(sim, mesh, n_rounds, params, spec,
                                axis="replica"):
    """sharded_advance for a Hamiltonian ensemble (BASELINE config 4):
    parameter leaves named in the stack_param_ensembles spec carry a
    per-slot leading axis and are split over the replica mesh axis next to
    the state; shared leaves (the large interaction tables) replicate, so
    each device holds one table copy and its local slots' scalars.  Runs
    under shard_map for the same share-nothing reason as
    sharded_advance."""
    from ..md.sim import param_axes  # noqa: F401  (spec documented there)
    shard = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    params = jax.tree_util.tree_map_with_path(
        lambda kp, x: jax.device_put(
            x, shard if jax.tree_util.keystr(kp) in spec else rep), params)
    pspecs = jax.tree_util.tree_map_with_path(
        lambda kp, x: P(axis) if jax.tree_util.keystr(kp) in spec else P(),
        params)
    body = jax.shard_map(lambda s, p: sim.advance(s, p, n_rounds, True,
                                                  spec),
                         mesh=mesh, in_specs=(P(axis), pspecs),
                         out_specs=P(axis), check_vma=False)
    compiled = jax.jit(body)

    def advance(state):
        state = shard_replica_state(state, mesh, axis)
        return compiled(state, params)

    # exposed for the collective audit (this path is a separate
    # compilation from sharded_advance and is audited on its own)
    advance.compiled = compiled
    return advance, params


def training_step(system, optimizer_update, axis="replica"):
    """One data-parallel force-matching/energy training step.

    Replaces the reference's MPI rank-0 RPC + comm.Reduce gradient sum
    (py/mpi_collective_object.py, py/tensorflow_upside.py:32-73): the loss
    gradient w.r.t. the parameter pytree is computed per system shard and
    psum'd over the replica axis inside shard_map.
    """
    def loss_fn(params, pos_batch, target_energy):
        e = jax.vmap(lambda p: system.energy(p, params))(pos_batch)
        return jnp.mean((e - target_energy) ** 2)

    def step(params, opt_state, pos_shard, target_shard):
        loss, grads = jax.value_and_grad(loss_fn)(params, pos_shard,
                                                  target_shard)
        loss = jax.lax.pmean(loss, axis)
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, axis), grads)
        new_params, new_opt_state = optimizer_update(params, grads, opt_state)
        return new_params, new_opt_state, loss

    return step


def sharded_training_step(system, optimizer_update, mesh, axis="replica"):
    """shard_map-wrapped version of training_step for a device mesh."""
    step = training_step(system, optimizer_update, axis)
    return jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False))


# HLO opcodes that move data between devices, point-to-point and ragged
# forms included
COLLECTIVE_OPS = ("all-reduce", "all-gather", "collective-permute",
                  "all-to-all", "reduce-scatter", "collective-broadcast",
                  "ragged-all-to-all", "send", "recv")


def collectives_in(hlo_text):
    """Cross-device collective opcodes found in a compiled program's HLO
    text (``compiled.as_text()``).  The sharded advances must have none:
    replicas share nothing between swaps."""
    return [op for op in COLLECTIVE_OPS
            if f" {op}(" in hlo_text or f" {op}-start(" in hlo_text]
