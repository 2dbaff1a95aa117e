"""Backbone steric repulsion (reference: src/backbone_steric.cpp).

Per residue, up to 4 reference atoms (N, CA, C, CB) are placed by the rigid
affine frame; residue pairs with |i-j| > 1 interact through a compact
sigmoid of squared distance that is exactly zero beyond r^2 = 9.3, so the
kernel itself truncates the interaction — no neighbor list is needed on a
dense masked layout.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.geometry import quat_to_rot
from ..ops.sigmoid import compact_sigmoid
from .base import register_node

ENERGY_SCALE = 4.0
WALL2 = 3.0 * 3.0
SHARPNESS = 1.0 / (3.0 * 0.10)  # 1/(wall*width), backbone_steric.cpp:22-27


def _backbone_pairs(consts, params, inputs, extra):
    affine = inputs[0][consts["id"]]       # (n_res, 7)
    ref_pos = consts["ref_pos"]            # (n_res, 4, 3)
    atom_mask = consts["atom_mask"]        # (n_res, 4) bool: na < n_atom

    t = affine[:, 0:3]
    R = quat_to_rot(affine[:, 3:7])
    # broadcast multiply-reduce, not a batched tiny dot_general (see
    # ops.geometry.rotate_vec)
    atoms = jnp.sum(R[:, None] * jnp.asarray(
        ref_pos, affine.dtype)[:, :, None, :], axis=-1) \
        + t[:, None, :]                    # (n_res, 4, 3)

    # flatten to atom level: one (4*n_res, 4*n_res) pair plane instead of
    # an (n_res, n_res, 4, 4) tensor with 4-wide trailing dims; the
    # residue-pair predicate becomes a per-atom residue-id
    # comparison (id gaps > 1, each unordered pair once)
    n_res = affine.shape[0]
    ax = atoms.reshape(n_res * 4, 3)
    rid = jnp.repeat(jnp.asarray(consts["id"]), 4)
    valid = jnp.asarray(atom_mask).reshape(-1)
    d = rid[:, None] - rid[None, :]
    mask = (d < -1) & valid[:, None] & valid[None, :]

    dx = ax[:, 0][None, :] - ax[:, 0][:, None]
    dy = ax[:, 1][None, :] - ax[:, 1][:, None]
    dz = ax[:, 2][None, :] - ax[:, 2][:, None]
    r2 = dx * dx + dy * dy + dz * dz
    v, _ = compact_sigmoid(r2 - WALL2, SHARPNESS)
    return ENERGY_SCALE * jnp.sum(jnp.where(mask, v, 0.0))


backbone_pairs = register_node("backbone_pairs", True, _backbone_pairs)
