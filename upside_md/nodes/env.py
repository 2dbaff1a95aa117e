"""Burial / environment subsystem (reference: src/environment.cpp).

* environment_coverage — direction-weighted burial count of each CB against
  Boltzmann-weighted sidechain points (radial x angular compact sigmoids)
* weighted_pos         — (x, y, z, exp(-E)) coupling of positions with an
  energy node
* uniform_transform    — 1D clamped B-spline transform of a scalar signal
* linear_coupling_uniform / linear_coupling_with_inactivation
* nonlinear_coupling   — per-restype clamped-spline energy of burial
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.pairs import safe_inv_dist, sequence_exclusion_mask
from ..ops.sigmoid import compact_sigmoid
from ..ops.spline import eval_clamped_bspline
from .base import register_node


def _environment_coverage(consts, params, inputs, extra):
    cb = inputs[0][consts["index1"]]   # (n1, 6): point + direction
    sc = inputs[1][consts["index2"]]   # (n2, 4): point + weight
    # per-parameter (n1, n2) planes from two one-hot matmuls each, so
    # every intermediate keeps the natural pair layout.  HIGHEST: an f32
    # dot at default precision may run in TF32 on the GPU, rounding the
    # burial parameters to ~1e-3 relative
    table = jnp.asarray(params["interaction_param"])
    oh1 = jax.nn.one_hot(consts["type1"], table.shape[0], dtype=table.dtype)
    oh2 = jax.nn.one_hot(consts["type2"], table.shape[1], dtype=table.dtype)
    HI = jax.lax.Precision.HIGHEST
    r0, r_sharp, dot0, dot_sharp = [
        jnp.dot(jnp.dot(oh1, table[:, :, c], precision=HI), oh2.T,
                precision=HI) for c in range(4)]

    # structure-of-planes geometry: (n1,1) x (1,n2) broadcasts only, no
    # (n1, n2, 3) intermediates with a 3-wide lane dim
    dx = sc[:, 0][None, :] - cb[:, 0][:, None]
    dy = sc[:, 1][None, :] - cb[:, 1][:, None]
    dz = sc[:, 2][None, :] - cb[:, 2][:, None]
    dist2 = dx * dx + dy * dy + dz * dz
    cutoff = r0 + 1.0 / r_sharp
    mask = sequence_exclusion_mask(consts["id1"], consts["id2"], 2) & \
        (dist2 < cutoff * cutoff)

    inv_dist = safe_inv_dist(dist2, mask=mask)
    dist = dist2 * inv_dist
    dp = inv_dist * (dx * cb[:, 3][:, None] + dy * cb[:, 4][:, None]
                     + dz * cb[:, 5][:, None])

    radial, _ = compact_sigmoid(dist - r0, r_sharp)
    angular, _ = compact_sigmoid(dot0 - dp, dot_sharp)
    score = jnp.where(mask, sc[:, 3][None, :] * radial * angular, 0.0)
    return jnp.sum(score, axis=1)[:, None]   # per-CB burial


environment_coverage = register_node(
    "environment_coverage", False, _environment_coverage)


def _weighted_pos(consts, params, inputs, extra):
    pos = inputs[0][consts["index_pos"], 0:3]
    w = jnp.exp(-inputs[1][consts["index_weight"], 0])
    return jnp.concatenate([pos, w[:, None]], axis=-1)


weighted_pos = register_node("weighted_pos", False, _weighted_pos)


def _uniform_transform(consts, params, inputs, extra):
    x = (inputs[0][:, 0] - params["spline_offset"]) * params["spline_inv_dx"]
    v, _ = eval_clamped_bspline(params["bspline_coeff"], x)
    return v[:, None]


def _ut_get_param(c, p):
    return np.concatenate([[float(p["spline_offset"])],
                           [float(p["spline_inv_dx"])],
                           np.asarray(p["bspline_coeff"])]).astype(np.float32)


def _ut_set_param(c, p, flat):
    flat = np.asarray(flat, np.float32)
    return c, {"spline_offset": jnp.asarray(flat[0]),
               "spline_inv_dx": jnp.asarray(flat[1]),
               "bspline_coeff": jnp.asarray(flat[2:])}


uniform_transform = register_node("uniform_transform", False,
                                  _uniform_transform,
                                  get_param=_ut_get_param,
                                  set_param=_ut_set_param)


def _linear_coupling(with_inactivation):
    def compute(consts, params, inputs, extra):
        c = params["couplings"][consts["coupling_types"]]
        val = inputs[0][:, 0]
        if with_inactivation:
            act = (1.0 - inputs[1][:, consts["inactivation_dim"]]) ** 2
        else:
            act = 1.0
        return jnp.sum(c * val * act)
    return compute


def _lc_get_param(c, p):
    return np.asarray(p["couplings"]).astype(np.float32)


def _lc_set_param(c, p, flat):
    return c, {"couplings": jnp.asarray(np.asarray(flat, np.float32))}


linear_coupling_uniform = register_node(
    "linear_coupling_uniform", True, _linear_coupling(False),
    get_param=_lc_get_param, set_param=_lc_set_param)
linear_coupling_with_inactivation = register_node(
    "linear_coupling_with_inactivation", True, _linear_coupling(True),
    get_param=_lc_get_param, set_param=_lc_set_param)


def _nonlinear_coupling(consts, params, inputs, extra):
    coeff = params["coeff"][consts["coupling_types"]]  # (n, n_coeff)
    x = (inputs[0][:, 0] - consts["spline_offset"]) * consts["spline_inv_dx"]
    v, _ = eval_clamped_bspline(coeff, x)
    return jnp.sum(v)


def _nc_get_param(c, p):
    return np.asarray(p["coeff"]).ravel().astype(np.float32)


def _nc_set_param(c, p, flat):
    shape = np.asarray(p["coeff"]).shape
    return c, {"coeff": jnp.asarray(np.asarray(flat, np.float32).reshape(shape))}


nonlinear_coupling = register_node(
    "nonlinear_coupling", True, _nonlinear_coupling,
    get_param=_nc_get_param, set_param=_nc_set_param)
