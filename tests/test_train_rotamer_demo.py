"""Energy-gap rotamer training (reference
rotamer_parameter_estimation.py:213-263): the state-restricted 'fixed'
system, the gap loss through the BP envelope, and the end-to-end demo
recovering rotamer-state accuracy from a degraded table."""

import numpy as np
import jax.numpy as jnp
import pytest

from upside_md.bench_systems import TRP_CAGE, build_full_system, \
    have_reference_params
from upside_md.training import (energy_gap_loss, fit_packed,
                                    rotamer_node_marginals, rotamer_packings,
                                    rotamer_state_restricted_system)

pytestmark = pytest.mark.skipif(not have_reference_params(),
                                reason="reference parameter libraries absent")


@pytest.fixture(scope="module")
def trp_system():
    return build_full_system(seq=TRP_CAGE)


def test_restricted_system_pins_states(trp_system, rng):
    system, params, pos, aux = trp_system
    consts = system.by_name["rotamer"].consts
    n_rot = np.asarray(consts["n_rot_per_res"])
    states = np.array([rng.integers(0, n) for n in n_rot])

    fixed = rotamer_state_restricted_system(system, states)
    nb = np.asarray(rotamer_node_marginals(fixed, jnp.asarray(pos), params))
    # the restricted problem's marginals are delta functions at the pins
    np.testing.assert_array_equal(nb.argmax(-1), states)
    assert nb.max(-1).min() > 0.999

    # free energy of the restricted problem >= free problem (pinning cost)
    e_fixed = float(fixed.energy(jnp.asarray(pos), params))
    e_free = float(system.energy(jnp.asarray(pos), params))
    assert e_fixed >= e_free - 1e-3

    # out-of-range state raises
    bad = states.copy()
    bad[np.argmax(n_rot)] = 6
    with pytest.raises(ValueError):
        rotamer_state_restricted_system(system, bad)


def test_energy_gap_training_recovers_accuracy(trp_system, rng):
    system, params, pos, aux = trp_system
    pos_batch = jnp.asarray(
        np.asarray(pos)[None]
        + 0.02 * rng.normal(size=(2,) + np.asarray(pos).shape)
    ).astype(jnp.float32)

    nb0 = np.asarray(rotamer_node_marginals(system, pos_batch[0], params))
    target = nb0.argmax(-1)
    fixed = rotamer_state_restricted_system(system, target)

    # degrade the table in packing space
    pk = rotamer_packings(params)["rotamer"]
    theta = np.asarray(pk.pack(params["rotamer"]["interaction_param"]))
    theta_bad = theta + 0.5 * rng.normal(size=theta.shape)
    params_bad = {k: dict(v) for k, v in params.items()}
    params_bad["rotamer"]["interaction_param"] = jnp.asarray(
        pk.unpack(jnp.asarray(theta_bad)), jnp.float32)

    multi = np.asarray(system.by_name["rotamer"].consts["n_rot_per_res"]) > 1

    def acc(p):
        ok = tot = 0
        for fpos in pos_batch:
            nb = np.asarray(rotamer_node_marginals(system, fpos, p))
            ok += int((nb.argmax(-1)[multi] == target[multi]).sum())
            tot += int(multi.sum())
        return ok / tot

    def loss_of_params(p):
        total = 0.0
        for i in range(pos_batch.shape[0]):
            total = total + energy_gap_loss(fixed, system, pos_batch[i])(
                p, {})
        return total / pos_batch.shape[0]

    acc_before = acc(params_bad)
    fitted, history = fit_packed(system, loss_of_params, params_bad,
                                 ["rotamer"], n_steps=60,
                                 learning_rate=0.03)
    acc_after = acc(fitted)

    assert history[-1] < history[0], "gap loss must decrease"
    assert acc_after >= acc_before, \
        f"training must not lose accuracy ({acc_before} -> {acc_after})"
    # with a 0.5-sigma degradation the recovery should be strict
    if acc_before < 0.999:
        assert acc_after > acc_before
