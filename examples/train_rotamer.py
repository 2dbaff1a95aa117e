"""End-to-end rotamer-table training demo (energy-gap objective).

The reference trains its sidechain interaction tables by maximizing the
probability of native rotamer states: the loss is the free-energy cost of
pinning every side chain to its native state, E_fixed - F_free, with the
table gradient flowing through the belief-propagation envelope
(py/rotamer_parameter_estimation.py:213-263).

This demo reproduces that loop on Trp-cage with the shipped libraries:

  1. equilibrate briefly and take a conformation batch,
  2. define "native" states as the shipped table's own argmax marginals,
  3. degrade the table in the constrained packing space (training.py
     QuadsplinePacking — every iterate is a physically valid table),
  4. train the degraded table with the energy-gap loss,
  5. report rotamer-state and chi1-bin accuracy before/after.

Run:  python examples/train_rotamer.py   (CPU ok; GPU faster)
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from upside_md.bench_systems import (SIDECHAIN, TRP_CAGE,
                                         build_full_system)
from upside_md.md.sim import Simulation
from upside_md.training import (energy_gap_loss, fit_packed,
                                    rotamer_node_marginals, rotamer_packings,
                                    rotamer_state_restricted_system)


def state_accuracy(system, pos_batch, params, target_states):
    ok = total = 0
    for pos in pos_batch:
        nb = np.asarray(rotamer_node_marginals(system, pos, params))
        multi = system.by_name["rotamer"].consts["n_rot_per_res"] > 1
        ok += int((nb.argmax(-1)[multi] == target_states[multi]).sum())
        total += int(multi.sum())
    return ok / max(total, 1)


def chi1_bin_accuracy(seq3, states_pred, states_true):
    """Map library states to chi1 bins (120-degree wells) and compare."""
    try:
        from upside_md.chi1 import Chi1Predict
        cp = Chi1Predict(SIDECHAIN)
    except Exception:
        return None
    rt = np.asarray([cp.restype_dict[a] for a in seq3])
    b_pred = cp.state_to_bin[rt, states_pred]
    b_true = cp.state_to_bin[rt, states_true]
    keep = (b_true >= 0) & (b_pred >= 0)
    return float((b_pred[keep] == b_true[keep]).mean())


def main(n_frames=6, n_train_steps=120, seed=3):
    system, params, pos, aux = build_full_system(seq=TRP_CAGE)

    # 1. conformation batch from a short equilibration
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     do_recenter=False)
    state = sim.initial_state(pos, params, seed=seed, temperature=0.8)
    frames = []
    for _ in range(n_frames):
        state = sim.advance(state, params, 10)
        frames.append(np.asarray(state.pos))
    pos_batch = jnp.asarray(np.stack(frames))

    # 2. "native" states: the shipped table's own argmax marginals on the
    #    first frame (stands in for crystallographic chi1 assignments)
    nb0 = np.asarray(rotamer_node_marginals(system, pos_batch[0], params))
    target_states = nb0.argmax(-1)
    fixed_system = rotamer_state_restricted_system(system, target_states)

    # 3. degrade the table in packing space (valid by construction)
    packs = rotamer_packings(params)
    pk = packs["rotamer"]
    rng = np.random.default_rng(seed)
    theta = np.asarray(pk.pack(params["rotamer"]["interaction_param"]))
    theta_bad = theta + 0.4 * rng.normal(size=theta.shape)
    params_bad = {k: dict(v) for k, v in params.items()}
    params_bad["rotamer"]["interaction_param"] = jnp.asarray(
        pk.unpack(jnp.asarray(theta_bad)), jnp.float32)

    acc0 = state_accuracy(system, pos_batch, params_bad, target_states)

    # 4. energy-gap training of the degraded table
    def loss_of_params(p):
        total = 0.0
        for i in range(pos_batch.shape[0]):
            lp = energy_gap_loss(fixed_system, system, pos_batch[i])
            total = total + lp(p, {})
        return total / pos_batch.shape[0]

    fitted, history = fit_packed(system, loss_of_params, params_bad,
                                 ["rotamer"], n_steps=n_train_steps,
                                 learning_rate=0.02)

    acc1 = state_accuracy(system, pos_batch, fitted, target_states)

    seq3 = aux.get("sequence") if isinstance(aux, dict) else None
    n_res_bp = int(system.by_name["rotamer"].consts["n_res"])
    if seq3 is not None and len(seq3) != n_res_bp:
        seq3 = None     # BP nodes don't map 1:1 onto sequence positions
    print(f"energy-gap loss: {history[0]:.3f} -> {history[-1]:.3f}")
    print(f"rotamer-state accuracy (multi-rotamer residues): "
          f"{acc0:.3f} -> {acc1:.3f}")
    if seq3 is not None:
        nb_bad = np.asarray(rotamer_node_marginals(
            system, pos_batch[0], params_bad)).argmax(-1)
        nb_fit = np.asarray(rotamer_node_marginals(
            system, pos_batch[0], fitted)).argmax(-1)
        c0 = chi1_bin_accuracy(seq3, nb_bad, target_states)
        c1 = chi1_bin_accuracy(seq3, nb_fit, target_states)
        if c0 is not None:
            print(f"chi1-bin accuracy: {c0:.3f} -> {c1:.3f}")
    return history, acc0, acc1


if __name__ == "__main__":
    main()
