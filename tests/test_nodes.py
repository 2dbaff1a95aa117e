"""Per-node energy/force checks: jax.grad vs central finite differences,
mirroring the reference's --potential-deriv-agreement tool
(src/main.cpp:279-315)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from upside_md import build_system
from upside_md.ops.spline import fit_periodic_bspline_2d

from helpers import affine_spec, chain_positions, rama_coord_spec, spec


def check_fd(system, pos, fd, tol=2e-4, eps=2e-5):
    params = system.make_params()

    def f(p):
        return float(system.energy(jnp.asarray(p), params))

    g_ad = np.asarray(jax.grad(system.energy)(jnp.asarray(pos), params))
    g_fd = fd(f, pos, eps=eps)
    scale = max(np.abs(g_fd).max(), 1e-6)
    err = np.abs(g_ad - g_fd).max() / scale
    assert err < tol, f"relative force error {err}"
    return g_ad


def test_dist_spring_fd(rng, fd):
    pos = chain_positions(3, rng)
    ids = np.array([[0, 1], [1, 2], [3, 5], [2, 7]], np.int32)
    s = spec("dist_spring", ["pos"], {"id": ids},
             {"equil_dist": np.full(4, 1.4), "spring_const": np.full(4, 10.0)})
    check_fd(build_system(9, [s]), pos, fd)


def test_angle_dihedral_springs_fd(rng, fd):
    pos = chain_positions(3, rng)
    s1 = spec("angle_spring", ["pos"],
              {"id": np.array([[0, 2, 1], [3, 5, 4]], np.int32)},
              {"equil_dp": np.array([-0.3, 0.1]),
               "spring_const": np.array([5.0, 7.0])})
    s2 = spec("dihedral_spring", ["pos"],
              {"id": np.array([[0, 1, 2, 3], [2, 3, 4, 5]], np.int32)},
              {"equil_dihedral": np.array([2.9, -3.0]),
               "spring_const": np.array([4.0, 3.0])})
    check_fd(build_system(9, [s1, s2]), pos, fd)


def test_pos_tension_cavity_z_fd(rng, fd):
    pos = chain_positions(2, rng) + np.array([3.0, 2.0, 1.0])
    specs = [
        spec("atom_pos_spring", ["pos"], {"id": np.array([0, 3], np.int32)},
             {"x0": rng.normal(size=(2, 3)), "spring_const": np.full(2, 2.0)}),
        spec("tension", ["pos"], {"atom": np.array([5], np.int32)},
             {"tension_coeff": np.array([[0.1, -0.2, 0.4]])}),
        spec("cavity_radial", ["pos"], {"id": np.array([1, 4], np.int32)},
             {"radius": np.array([2.0, 1.0]),
              "spring_const": np.array([3.0, 2.0])}),
        spec("z_flat_bottom", ["pos"], {"atom": np.array([2], np.int32)},
             {"z0": np.array([0.1]), "radius": np.array([0.05]),
              "spring_const": np.array([9.0])}),
    ]
    check_fd(build_system(6, specs), pos, fd)


def test_rama_map_pot_fd(rng, fd):
    n_res = 4
    pos = chain_positions(n_res, rng)
    rspec = rama_coord_spec(n_res)
    raw = rng.normal(size=(2, 12, 12))
    mspec = spec("rama_map_pot", ["rama_coord"],
                 {"residue_id": np.arange(n_res, dtype=np.int32),
                  "rama_map_id": np.array([0, 1, 0, 1], np.int32),
                  "raw_map": raw},
                 {"coeffs": fit_periodic_bspline_2d(raw)})
    check_fd(build_system(3 * n_res, [rspec, mspec]), pos, fd)


def test_affine_backbone_pairs_fd(rng, fd):
    n_res = 5
    # compress the chain so that |i-j|>1 residue pairs actually clash
    pos = chain_positions(n_res, rng) * np.array([0.35, 1.0, 1.0])
    aspec = affine_spec(n_res, rng)
    ref_pos = 0.8 * rng.normal(size=(n_res, 4, 3))
    bspec = spec("backbone_pairs", ["affine_alignment"],
                 {"id": np.arange(n_res, dtype=np.int32),
                  "ref_pos": ref_pos,
                  "atom_mask": np.arange(4)[None, :] <
                  np.array([4, 3, 4, 4, 3])[:, None]})
    sys = build_system(3 * n_res, [aspec, bspec])
    e = float(sys.energy(jnp.asarray(pos), sys.make_params()))
    assert e > 0  # random compact-ish chains should clash somewhere
    check_fd(sys, pos, fd, tol=5e-4)


def test_placement_fixed_fd(rng, fd):
    n_res = 3
    pos = chain_positions(n_res, rng)
    aspec = affine_spec(n_res, rng)
    pspec = spec("placement_fixed_point_only", ["affine_alignment"],
                 {"affine_residue": np.arange(n_res, dtype=np.int32),
                  "layer_index": np.array([1, 0, 1], np.int32)},
                 {"placement_data": rng.normal(size=(2, 3))})
    # anchor an energy on placed points so FD has something to push against
    espec = spec("atom_pos_spring", ["placement_fixed_point_only"],
                 {"id": np.arange(n_res, dtype=np.int32)},
                 {"x0": rng.normal(size=(n_res, 3)),
                  "spring_const": np.full(n_res, 1.0)})
    check_fd(build_system(3 * n_res, [aspec, pspec, espec]), pos, fd)


def test_placement_rama_fd(rng, fd):
    n_res = 3
    pos = chain_positions(n_res, rng)
    aspec = affine_spec(n_res, rng)
    rspec = rama_coord_spec(n_res)
    raw = rng.normal(size=(2, 10, 10, 3))
    coeffs = np.stack([fit_periodic_bspline_2d(raw[..., d])
                       for d in range(3)], -1)
    pspec = spec("placement_point_only", ["affine_alignment", "rama_coord"],
                 {"affine_residue": np.arange(n_res, dtype=np.int32),
                  "rama_residue": np.arange(n_res, dtype=np.int32),
                  "layer_index": np.array([0, 1, 0], np.int32)},
                 {"coeffs": coeffs})
    espec = spec("atom_pos_spring", ["placement_point_only"],
                 {"id": np.arange(n_res, dtype=np.int32)},
                 {"x0": rng.normal(size=(n_res, 3)),
                  "spring_const": np.full(n_res, 1.0)})
    check_fd(build_system(3 * n_res, [aspec, rspec, pspec, espec]), pos, fd)


def _hbond_specs(n_res):
    # donors: N of residues 1..n-1 (prevC, N, CA); acceptors: O from
    # (N_next?, C, CA) — synthetic index choices, geometry only needs to
    # be consistent
    don = [[3 * r - 1, 3 * r, 3 * r + 1] for r in range(1, n_res)]
    acc = [[3 * r + 3, 3 * r + 2, 3 * r + 1] for r in range(0, n_res - 1)]
    ids = np.array(don + acc, np.int32)
    nd = len(don)
    na = len(acc)
    ispec = spec("infer_H_O", ["pos"],
                 {"id": ids, "bond_length": np.full(nd + na, 1.0)})
    iparam = np.array([[[1.4, 10.0, 2.5, 8.0, 0.2, 10.0, 0.0, 0.0]]])
    hspec = spec("protein_hbond", ["infer_H_O"],
                 {"index1": np.arange(nd, dtype=np.int32),
                  "index2": nd + np.arange(na, dtype=np.int32),
                  "type1": np.zeros(nd, np.int32),
                  "type2": np.zeros(na, np.int32)},
                 {"interaction_param": iparam})
    espec = spec("hbond_energy", ["protein_hbond"], {},
                 {"protein_hbond_energy": np.asarray(-2.0)})
    return [ispec, hspec, espec], nd, na


def test_hbond_chain_fd(rng, fd):
    n_res = 4
    pos = chain_positions(n_res, rng, noise=0.25)
    specs, nd, na = _hbond_specs(n_res)
    sys = build_system(3 * n_res, specs)
    params = sys.make_params()
    out = np.asarray(sys.get_output(jnp.asarray(pos), params, "protein_hbond"))
    assert out.shape == (nd + na, 7)
    assert (out[:, 6] >= 0).all() and (out[:, 6] < 1).all()
    check_fd(sys, pos, fd, tol=5e-4)


def test_hbond_energy_counts(rng):
    n_res = 4
    pos = chain_positions(n_res, rng, noise=0.25)
    specs, nd, na = _hbond_specs(n_res)
    sys = build_system(3 * n_res, specs)
    params = sys.make_params()
    out = np.asarray(sys.get_output(jnp.asarray(pos), params, "protein_hbond"))
    e = float(sys.energy(jnp.asarray(pos), params))
    assert abs(e - (-2.0) * out[:, 6].sum()) < 1e-8


def test_get_sens_matches_manual_grad(rng):
    # sens of the rama node under rama_map_pot == d(pot)/d(rama) cotangent
    n_res = 3
    pos = jnp.asarray(chain_positions(n_res, rng))
    rspec = rama_coord_spec(n_res)
    raw = rng.normal(size=(1, 8, 8))
    mspec = spec("rama_map_pot", ["rama_coord"],
                 {"residue_id": np.arange(n_res, dtype=np.int32),
                  "rama_map_id": np.zeros(n_res, np.int32),
                  "raw_map": raw},
                 {"coeffs": fit_periodic_bspline_2d(raw)})
    sys = build_system(3 * n_res, [rspec, mspec])
    params = sys.make_params()
    sens = sys.get_sens(pos, params, "rama_coord")
    assert sens.shape == (n_res, 2)
    # FD in rama space: vary one rama component through injection
    base = sys.evaluate(pos, params)[0]
    eps = 1e-5
    z = np.zeros((n_res, 2))
    z[1, 0] = eps
    ep = sys.evaluate(pos, params, inject={"rama_coord": jnp.asarray(z)})[0]
    em = sys.evaluate(pos, params, inject={"rama_coord": jnp.asarray(-z)})[0]
    assert abs((float(ep) - float(em)) / (2 * eps) - float(sens[1, 0])) < 1e-4


def test_radial_pair_fd(rng, fd):
    n = 6
    pos = np.asarray(chain_positions(2, rng))
    # radial node over 6 points with 2 types
    coeffs = np.concatenate([rng.normal(size=14), np.zeros(2)])
    coeffs[0] = coeffs[2]  # left clamp convention
    table = np.zeros((2, 2, 17))
    table[..., 0] = 1.0 / 0.6
    table[..., 1:] = coeffs
    s = spec("radial", ["pos"],
             {"index": np.arange(n, dtype=np.int32),
              "type": np.array([0, 1, 0, 1, 0, 1], np.int32),
              "id": np.arange(n, dtype=np.int32) * 3},  # all pairs allowed
             {"interaction_param": table})
    check_fd(build_system(n, [s]), pos, fd, tol=5e-4)
