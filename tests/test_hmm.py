"""fixed_hmm: -log Z against brute-force path enumeration; torus_dbn
emission energies against the closed-form von-Mises expression."""

import itertools

import numpy as np
import jax
import jax.numpy as jnp

from upside_md import build_system

from helpers import spec


def test_fixed_hmm_matches_enumeration(rng):
    n_res, n_state = 5, 3
    e1 = rng.normal(size=(n_res, n_state))
    te = rng.normal(size=(n_state, n_state))

    specs = [
        spec("constant", [], {}, {"value": e1}),
        spec("fixed_hmm", ["constant"],
             {"index": np.arange(n_res, dtype=np.int32)},
             {"transition_energy": te}),
    ]
    sys = build_system(1, specs)
    pot = float(sys.energy(jnp.zeros((1, 3)), sys.make_params()))

    zs = []
    for s in itertools.product(range(n_state), repeat=n_res):
        e = sum(e1[r, s[r]] for r in range(n_res))
        e += sum(te[s[r], s[r + 1]] for r in range(n_res - 1))
        zs.append(-e)
    zs = np.array(zs)
    m = zs.max()
    exact = -(m + np.log(np.exp(zs - m).sum()))
    assert abs(pot - exact) < 1e-5, (pot, exact)


def test_fixed_hmm_sens_is_posterior(rng):
    # d(-logZ)/d(e1[r,s]) equals the posterior state marginal
    n_res, n_state = 4, 3
    e1 = rng.normal(size=(n_res, n_state))
    te = rng.normal(size=(n_state, n_state))
    specs = [
        spec("constant", [], {}, {"value": e1}),
        spec("fixed_hmm", ["constant"],
             {"index": np.arange(n_res, dtype=np.int32)},
             {"transition_energy": te}),
    ]
    sys = build_system(1, specs)
    params = sys.make_params()
    sens = np.asarray(sys.get_sens(jnp.zeros((1, 3)), params, "constant"))

    # brute-force posterior marginals
    marg = np.zeros((n_res, n_state))
    Z = 0.0
    for s in itertools.product(range(n_state), repeat=n_res):
        e = sum(e1[r, s[r]] for r in range(n_res))
        e += sum(te[s[r], s[r + 1]] for r in range(n_res - 1))
        w = np.exp(-e)
        Z += w
        for r in range(n_res):
            marg[r, s[r]] += w
    marg /= Z
    np.testing.assert_allclose(sens, marg, atol=1e-5)


def test_fixed_hmm_param_deriv_is_transition_counts(rng):
    n_res, n_state = 4, 2
    e1 = rng.normal(size=(n_res, n_state))
    te = rng.normal(size=(n_state, n_state))
    specs = [
        spec("constant", [], {}, {"value": e1}),
        spec("fixed_hmm", ["constant"],
             {"index": np.arange(n_res, dtype=np.int32)},
             {"transition_energy": te}),
    ]
    sys = build_system(1, specs)
    params = sys.make_params()
    pd = np.asarray(sys.param_deriv(jnp.zeros((1, 3)), params,
                                    "fixed_hmm")["transition_energy"])

    counts = np.zeros((n_state, n_state))
    Z = 0.0
    for s in itertools.product(range(n_state), repeat=n_res):
        e = sum(e1[r, s[r]] for r in range(n_res))
        e += sum(te[s[r], s[r + 1]] for r in range(n_res - 1))
        w = np.exp(-e)
        Z += w
        for r in range(n_res - 1):
            counts[s[r], s[r + 1]] += w
    counts /= Z
    np.testing.assert_allclose(pd, counts, atol=1e-5)


def test_torus_dbn_emission(rng):
    n_res, n_state, n_restype = 3, 2, 4
    rama = rng.uniform(-np.pi, np.pi, size=(n_res, 2))
    bp = rng.normal(size=(n_state, 6))
    bp[:, 1] = np.abs(bp[:, 1])
    bp[:, 3] = np.abs(bp[:, 3])
    prior = rng.normal(size=(n_restype, n_state))
    restypes = np.array([1, 3, 0], np.int32)

    specs = [
        spec("constant", [], {}, {"value": rama}),
        spec("torus_dbn", ["constant"],
             {"id": np.arange(n_res, dtype=np.int32),
              "restypes": restypes, "basin_param": bp},
             {"prior_offset_energies": prior}),
    ]
    sys = build_system(1, specs)
    out = np.asarray(sys.get_output(jnp.zeros((1, 3)), sys.make_params(),
                                    "torus_dbn"))
    for r in range(n_res):
        phi, psi = rama[r]
        for s in range(n_state):
            expect = (prior[restypes[r], s] + bp[s, 0]
                      - bp[s, 1] * np.cos(phi - bp[s, 2])
                      - bp[s, 3] * np.cos(psi - bp[s, 4])
                      + bp[s, 5] * np.cos(phi - psi - (bp[s, 2] - bp[s, 4])))
            assert abs(out[r, s] - expect) < 1e-5
