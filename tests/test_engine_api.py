"""Upside engine API parity: energy/deriv/set_param/get_param_deriv/
get_output/get_sens/get_value_by_name/freeze."""

import numpy as np
import jax.numpy as jnp
import pytest

from upside_md.engine import Upside
from upside_md.system import freeze_static_nodes

from test_cli_and_analysis import small_config


def test_engine_api_roundtrip(tmp_path):
    path = small_config(tmp_path)
    engine = Upside(path)
    pos = engine._pos
    e = engine.energy(pos)
    assert np.isfinite(e)
    d = engine.deriv(pos)
    assert d.shape == (engine.n_atom, 3)

    out = engine.get_output('protein_hbond')
    assert out.shape[1] == 7
    sens = engine.get_sens('rama_coord')
    assert sens.shape == (engine.n_atom // 3, 2)

    # hbond_energy param round-trip: energy scales linearly
    p0 = engine.get_param('hbond_energy')
    hb_total = out[:, 6].sum()
    engine.set_param(np.array([2.0 * p0[0]]), 'hbond_energy')
    e2 = engine.energy(pos)
    assert abs((e2 - e) - p0[0] * hb_total) < 1e-3

    # param deriv of hbond energy = total hbond count (reference
    # hbond.cpp:446-449)
    pd = engine.get_param_deriv('hbond_energy')
    assert abs(pd[0] - hb_total) < 1e-4


def test_engine_param_deriv_analytic(tmp_path):
    path = small_config(tmp_path)
    engine = Upside(path)
    pos = np.asarray(engine._pos)
    engine.energy(pos)
    # analytic check: dE/d(equil_dist_i) = -k_i (|d_i| - d0_i)
    pd = engine.get_param_deriv('dist_spring')
    spec = engine.system.by_name['dist_spring']
    ids = spec.consts['id']
    d = np.linalg.norm(pos[ids[:, 0]] - pos[ids[:, 1]], axis=-1)
    d0 = np.asarray(engine.params['dist_spring']['equil_dist'])
    k = np.asarray(engine.params['dist_spring']['spring_const'])
    expect_eq = -k * (d - d0)       # derivative w.r.t. equil_dist
    expect_k = 0.5 * (d - d0) ** 2  # derivative w.r.t. spring_const
    n = len(d)
    np.testing.assert_allclose(pd[:n], expect_eq, atol=1e-3)
    np.testing.assert_allclose(pd[n:], expect_k, atol=1e-4)


def test_freeze_static_nodes(tmp_path):
    path = small_config(tmp_path)
    engine = Upside(path)
    sys0 = engine.system
    frozen, fparams = freeze_static_nodes(sys0, engine.params)
    pos = jnp.asarray(engine._pos)
    e0 = float(sys0.energy(pos, engine.params))
    e1 = float(frozen.energy(pos, fparams))
    assert abs(e0 - e1) < 1e-5


def test_count_edges_by_type_channels():
    """Every igraph-style node serves the count_edges_by_type channel
    (interaction_graph.h:427-441, hbond.cpp:406-412)."""
    import os

    import pytest
    if not os.path.exists("/root/reference/parameters/ff_1/sidechain.h5"):
        pytest.skip("no parameter libraries")
    from upside_md.bench_systems import TRP_CAGE, build_full_system
    from upside_md.engine import Upside

    system, params, pos, aux = build_full_system(seq=TRP_CAGE)
    eng = Upside(system, params, pos)
    for node in ("rotamer", "hbond_coverage"):
        counts = eng.get_value_by_name(node, "count_edges_by_type")
        assert counts.ndim == 1 and counts.sum() >= 0
    import numpy as np
    c = np.asarray(eng.get_value_by_name("rotamer", "count_edges_by_type"))
    n_type = 20
    assert c.size == n_type * n_type
