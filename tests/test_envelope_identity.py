"""Cross-check the envelope-theorem wiring on the full forcefield: the
autodiff sensitivity of every rotamer 1-body input equals the BP posterior
bead marginal (how the reference computes chi1 probabilities,
rotamer.cpp:973-985, predict_chi1.py:105)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from upside_md.config.reader import load_system
from upside_md.nodes.rotamer import rotamer_diagnostics

from test_config_end_to_end import SIDECHAIN, build_full_config, needs_params


@needs_params
def test_sens_equals_bead_marginals(tmp_path):
    path = build_full_config(tmp_path)
    system, params, pos, aux = load_system(path)
    pos = jnp.asarray(pos)

    # marginals straight from the BP solve
    spec = system.by_name['rotamer']
    _, outputs, _ = system.evaluate(pos, params)
    inputs = [outputs[a] for a in spec.args]
    diag = rotamer_diagnostics(spec.consts, params['rotamer'], inputs)
    bead_marg = np.asarray(diag['bead_marginal'])

    # hbond_coverage feeds ONLY the BP 1-body energies, so its output
    # sensitivity is exactly the posterior bead marginal (the chi1
    # channel).  placement_scalar would NOT satisfy this: it also feeds
    # the environment chain through weighted_pos, so its sensitivity
    # accumulates both paths.
    sens_cov = np.asarray(system.get_sens(pos, params,
                                          'hbond_coverage'))[:, 0]
    np.testing.assert_allclose(sens_cov, bead_marg, atol=2e-3)

    # node marginals are proper distributions over valid rotamers
    nb = np.asarray(diag['node_marginal'])
    valid = np.asarray(spec.consts['valid'])
    np.testing.assert_allclose(nb.sum(-1), 1.0, atol=1e-4)
    assert np.all(nb[~valid] == 0.0)
