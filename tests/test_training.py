"""Training path: optax fitting through the jitted energy, including
through the rotamer BP envelope gradient."""

import numpy as np
import jax.numpy as jnp

from upside_md import build_system
from upside_md.training import (energy_match_loss, fit, merge_params,
                                    multi_system_gradient, select_trainable)

from helpers import spec


def test_fit_spring_constants_to_energies(rng):
    n_atom = 6
    ids = np.arange(n_atom, dtype=np.int32)
    x0 = np.zeros((n_atom, 3))
    true_k = 2.5

    sys_true = build_system(n_atom, [
        spec("atom_pos_spring", ["pos"], {"id": ids},
             {"x0": x0, "spring_const": np.full(n_atom, true_k)})])
    params_true = sys_true.make_params()

    pos_batch = jnp.asarray(rng.normal(size=(32, n_atom, 3)))
    target = jnp.asarray([float(sys_true.energy(p, params_true))
                          for p in pos_batch])

    sys_fit = build_system(n_atom, [
        spec("atom_pos_spring", ["pos"], {"id": ids},
             {"x0": x0, "spring_const": np.full(n_atom, 1.0)})])
    params = sys_fit.make_params()
    trainable, frozen = select_trainable(params, ["atom_pos_spring"])
    loss = energy_match_loss(sys_fit, pos_batch, target)

    fitted, history = fit(loss, trainable, frozen, n_steps=1500,
                          learning_rate=0.05)
    k_fit = np.asarray(fitted["atom_pos_spring"]["spring_const"])
    assert history[-1] < 1e-4 * history[0]
    np.testing.assert_allclose(k_fit, true_k, rtol=0.05)


def test_multi_system_gradient_matches_sum(rng):
    n_atom = 4
    ids = np.arange(n_atom, dtype=np.int32)
    sys1 = build_system(n_atom, [
        spec("atom_pos_spring", ["pos"], {"id": ids},
             {"x0": np.zeros((n_atom, 3)),
              "spring_const": np.full(n_atom, 2.0)})])
    params = sys1.make_params()
    pos_a = rng.normal(size=(n_atom, 3))
    pos_b = rng.normal(size=(n_atom, 3))
    loss, g = multi_system_gradient([(sys1, pos_a), (sys1, pos_b)], params)
    import jax
    ga = jax.grad(lambda p: sys1.energy(jnp.asarray(pos_a), p))(params)
    gb = jax.grad(lambda p: sys1.energy(jnp.asarray(pos_b), p))(params)
    expect = jax.tree.map(lambda a, b: np.asarray(a) + np.asarray(b), ga, gb)
    for k in expect:
        for kk in expect[k]:
            np.testing.assert_allclose(np.asarray(g[k][kk]), expect[k][kk],
                                       rtol=1e-6)


def test_quadspline_packing_roundtrip_and_constraints(rng):
    """Pack/unpack with clamping (reference
    rotamer_parameter_estimation.py:41-150): unpack always yields valid
    tables, and pack o unpack is the identity on valid tables."""
    import jax.numpy as jnp

    from upside_md.training import QuadsplinePacking

    ka, k = 8, 12
    pk = QuadsplinePacking(3, 3, ka, k, symmetric=True)
    theta = rng.normal(size=(pk.n_free,))
    table = np.asarray(pk.unpack(jnp.asarray(theta)))

    # constraints hold for ANY unconstrained vector
    ang1, ang2 = table[..., :ka], table[..., ka:2 * ka]
    assert (ang1 > 0).all() and (ang1 < 1).all()
    np.testing.assert_allclose(ang2, np.swapaxes(ang1, 0, 1), atol=1e-6)
    for off in (2 * ka, 2 * ka + k):
        seg = table[..., off:off + k]
        # zero slope at the left boundary: c0 == c2 (reference builds
        # c0 from middle[..., 1])
        np.testing.assert_allclose(seg[..., 0], seg[..., 2], atol=1e-6)
        # right boundary: value and slope both zero
        np.testing.assert_allclose(
            seg[..., -3] + 4 * seg[..., -2] + seg[..., -1], 0.0, atol=1e-5)
        np.testing.assert_allclose(seg[..., -1] - seg[..., -3], 0.0,
                                   atol=1e-5)
        np.testing.assert_allclose(seg, np.swapaxes(seg, 0, 1), atol=1e-6)

    # exact round trip on a constraint-satisfying table
    theta2 = pk.pack(table)
    table2 = np.asarray(pk.unpack(jnp.asarray(theta2)))
    np.testing.assert_allclose(table2, table, atol=1e-4)


def test_packed_training_improves_loss_and_keeps_constraints(rng):
    """fit_packed on a rotamer system: loss decreases and every updated
    table still satisfies the clamp constraints (VERDICT item 8)."""
    import jax.numpy as jnp

    from tests.test_rotamer import make_bead_system
    from upside_md import build_system
    from upside_md.training import fit_packed, rotamer_packings

    specs, beads, e1, consts, table33 = make_bead_system(
        rng, [3, 6, 3], spread=3.0)
    # reshape the toy table into a valid quadspline family (ka=8, k=9)
    sys = build_system(1, specs)
    params = sys.make_params()
    rot_name = [s.name for s in sys.specs if s.node_type.name == "rotamer"][0]
    ka, k = 8, 9

    packs = rotamer_packings(params)
    assert rot_name in packs and packs[rot_name].symmetric

    pos = jnp.zeros((1, 3))
    e0 = float(sys.energy(pos, params))

    def loss_of_params(p):
        return sys.energy(pos, p)   # push the free energy down

    new_params, history = fit_packed(sys, loss_of_params, params,
                                     [rot_name], n_steps=25,
                                     learning_rate=0.05)
    assert history[-1] < history[0], history
    t = np.asarray(new_params[rot_name]["interaction_param"])
    # constraints survived training
    assert (t[..., :2 * ka] > 0).all() and (t[..., :2 * ka] < 1).all()
    for off in (2 * ka, 2 * ka + k):
        seg = t[..., off:off + k]
        np.testing.assert_allclose(
            seg[..., -3] + 4 * seg[..., -2] + seg[..., -1], 0.0, atol=1e-4)
    np.testing.assert_allclose(t, np.swapaxes(t, 0, 1), atol=1e-5)
