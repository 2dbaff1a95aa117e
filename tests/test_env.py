"""Environment/burial chain, membrane, coverage and NN node checks."""

import numpy as np
import jax.numpy as jnp

from upside_md import build_system
from upside_md.nodes.membrane import make_membrane_params
from upside_md.ops.spline import fit_clamped_interp_bspline

from helpers import affine_spec, chain_positions, spec
from test_nodes import check_fd


def _cb_and_weighted(n_res, rng):
    """placement of CB point+vector, a scalar energy per residue, and the
    weighted_pos coupling — the standard burial chain input."""
    aspec = affine_spec(n_res, rng)
    cb = spec("placement_fixed_point_vector_only", ["affine_alignment"],
              {"affine_residue": np.arange(n_res, dtype=np.int32),
               "layer_index": np.zeros(n_res, np.int32)},
              {"placement_data": np.array([[1.0, 0.4, -0.2,
                                            0.5, 0.7, 0.5]])})
    escalar = spec("placement_fixed_scalar", ["affine_alignment"],
                   {"affine_residue": np.arange(n_res, dtype=np.int32),
                    "layer_index": np.zeros(n_res, np.int32)},
                   {"placement_data": np.array([[0.3]])})
    wp = spec("weighted_pos", ["placement_fixed_point_vector_only",
                               "placement_fixed_scalar"],
              {"index_pos": np.arange(n_res, dtype=np.int32),
               "index_weight": np.arange(n_res, dtype=np.int32)})
    return [aspec, cb, escalar, wp]


def test_environment_chain_fd(rng, fd):
    n_res = 5
    pos = chain_positions(n_res, rng) * np.array([0.5, 1.0, 1.0])
    specs = _cb_and_weighted(n_res, rng)
    table = np.zeros((1, 1, 4))
    table[..., :] = [6.0, 0.8, -0.5, 1.0]  # r0, r_sharp, dot0, dot_sharp
    env = spec("environment_coverage",
               ["placement_fixed_point_vector_only", "weighted_pos"],
               {"index1": np.arange(n_res, dtype=np.int32),
                "index2": np.arange(n_res, dtype=np.int32),
                "type1": np.zeros(n_res, np.int32),
                "type2": np.zeros(n_res, np.int32),
                "id1": np.arange(n_res, dtype=np.int32),
                "id2": np.arange(n_res, dtype=np.int32)},
               {"interaction_param": table})
    coeff = rng.normal(size=(2, 8))
    nc = spec("nonlinear_coupling", ["environment_coverage"],
              {"coupling_types": np.array([0, 1, 0, 1, 0], np.int32),
               "spline_offset": -1.0, "spline_inv_dx": 2.0},
              {"coeff": coeff})
    sys = build_system(3 * n_res, specs + [env, nc])
    out = np.asarray(sys.get_output(jnp.asarray(pos), sys.make_params(),
                                    "environment_coverage"))
    assert out.shape == (n_res, 1) and (out >= 0).all() and out.max() > 0
    check_fd(sys, pos, fd, tol=5e-4)


def test_uniform_transform_linear_coupling_fd(rng, fd):
    n_res = 4
    pos = chain_positions(n_res, rng) * np.array([0.5, 1.0, 1.0])
    specs = _cb_and_weighted(n_res, rng)
    table = np.zeros((1, 1, 4))
    table[..., :] = [6.0, 0.8, -0.5, 1.0]
    env = spec("environment_coverage",
               ["placement_fixed_point_vector_only", "weighted_pos"],
               {"index1": np.arange(n_res, dtype=np.int32),
                "index2": np.arange(n_res, dtype=np.int32),
                "type1": np.zeros(n_res, np.int32),
                "type2": np.zeros(n_res, np.int32),
                "id1": np.arange(n_res, dtype=np.int32),
                "id2": np.arange(n_res, dtype=np.int32)},
               {"interaction_param": table})
    ut = spec("uniform_transform", ["environment_coverage"], {},
              {"spline_offset": np.asarray(-0.5),
               "spline_inv_dx": np.asarray(1.5),
               "bspline_coeff": rng.normal(size=9)})
    lc = spec("linear_coupling_uniform", ["uniform_transform"],
              {"coupling_types": np.array([0, 1, 1, 0], np.int32)},
              {"couplings": np.array([0.7, -0.4])})
    sys = build_system(3 * n_res, specs + [env, ut, lc])
    check_fd(sys, pos, fd, tol=5e-4)


def test_membrane_fd(rng, fd):
    n_res = 4
    pos = chain_positions(n_res, rng) * np.array([0.5, 1.0, 1.0])
    specs = _cb_and_weighted(n_res, rng)
    table = np.zeros((1, 1, 4))
    table[..., :] = [6.0, 0.8, -0.5, 1.0]
    env = spec("environment_coverage",
               ["placement_fixed_point_vector_only", "weighted_pos"],
               {"index1": np.arange(n_res, dtype=np.int32),
                "index2": np.arange(n_res, dtype=np.int32),
                "type1": np.zeros(n_res, np.int32),
                "type2": np.zeros(n_res, np.int32),
                "id1": np.arange(n_res, dtype=np.int32),
                "id2": np.arange(n_res, dtype=np.int32)},
               {"interaction_param": table})
    # minimal hbond network for the uhb term
    don = [[3 * r - 1, 3 * r, 3 * r + 1] for r in range(1, n_res)]
    acc = [[3 * r + 3, 3 * r + 2, 3 * r + 1] for r in range(0, n_res - 1)]
    nd, na = len(don), len(acc)
    ispec = spec("infer_H_O", ["pos"],
                 {"id": np.array(don + acc, np.int32),
                  "bond_length": np.full(nd + na, 1.0)})
    hspec = spec("protein_hbond", ["infer_H_O"],
                 {"index1": np.arange(nd, dtype=np.int32),
                  "index2": nd + np.arange(na, dtype=np.int32),
                  "type1": np.zeros(nd, np.int32),
                  "type2": np.zeros(na, np.int32)},
                 {"interaction_param":
                  np.array([[[1.4, 10.0, 2.5, 8.0, 0.2, 10.0, 0, 0]]])})

    cb_energy = rng.normal(size=(2, 10))
    uhb_energy = rng.normal(size=(2, 10))
    mem = spec("membrane_potential",
               ["placement_fixed_point_vector_only",
                "environment_coverage", "protein_hbond"],
               {"cb_index": np.arange(n_res, dtype=np.int32),
                "env_index": np.arange(n_res, dtype=np.int32),
                "residue_type": np.array([0, 1, 0, 1], np.int32),
                "cov_midpoint": np.array([1.0, 2.0]),
                "cov_sharpness": np.array([1.0, 0.5]),
                "cb_z_shift": 3.0, "cb_z_scale": 1.4,
                "uhb_z_shift": 3.0, "uhb_z_scale": 1.4,
                "n_donor": nd},
               make_membrane_params(cb_energy, uhb_energy))
    sys = build_system(3 * n_res, specs + [env, ispec, hspec, mem])
    check_fd(sys, pos, fd, tol=7e-4)


def test_conv1d_and_featurizer(rng, fd):
    n = 6
    feat = rng.normal(size=(n, 4))
    w = rng.normal(size=(3, 4, 2))
    b = rng.normal(size=2)
    specs = [
        spec("constant", [], {}, {"value": feat}),
        spec("conv1d", ["constant"], {"activation": "Tanh"},
             {"weights": w, "bias": b}),
        spec("scaled_sum", ["conv1d"], {"scale": 0.5}, {}),
    ]
    sys = build_system(1, specs)
    params = sys.make_params()
    out = np.asarray(sys.get_output(jnp.zeros((1, 3)), params, "conv1d"))
    assert out.shape == (n - 2, 2)
    # reference semantics: valid conv, window w stacks input rows
    expect = np.tanh(np.einsum('nwc,wco->no', np.stack(
        [feat[i:i + n - 2] for i in range(3)], 1), w) + b)
    np.testing.assert_allclose(out, expect, atol=1e-6)
    e = float(sys.energy(jnp.zeros((1, 3)), params))
    assert abs(e - 0.5 * expect[:, 0:1].sum()) < 1e-5
