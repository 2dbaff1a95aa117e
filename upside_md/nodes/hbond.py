"""Backbone hydrogen-bond subsystem (reference: src/hbond.cpp).

* infer_H_O      — virtual amide H / carbonyl O positions and bond
                   directions from 3 backbone atoms assuming 120-degree
                   geometry (hbond.cpp:59-118).
* protein_hbond  — donor x acceptor pair network; per-pair hbond strength
                   from a radial double-sigmoid times two angular sigmoids;
                   per-virtual probability hb = 1 - exp(-sum of -log(1-hb_pair))
                   (hbond.cpp:151-336).  Output width 7: the 6 infer values
                   plus hb.
* hbond_coverage — sidechain-bead coverage of HBond virtuals weighted by
                   (1-hb)^2, used for chi1 prediction (hbond.cpp:241-286).
* hbond_energy   — scalar E * sum(hb) (hbond.cpp:430-444).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.pairs import (gather_pair_params, pair_coverage,
                         quadspline_coverage_nl, quadspline_family,
                         sequence_exclusion_mask)
from .base import register_node

COVERAGE_NEIGHBOR_K = 96    # fixed neighbor-list width for coverage kernels
# sidechain count beyond which coverage switches to the neighbor list; the
# crossover against the masked dense grid is not measured on the GPU
COVERAGE_NL_THRESHOLD = 1024

RADIAL_CUTOFF2 = 3.5 * 3.5  # hbond.cpp:124


def _infer_h_o(consts, params, inputs, extra):
    pos = inputs[0]
    ids = consts["id"]   # (n_virtual, 3): prev, curr, next heavy atoms
    bond_length = consts["bond_length"]  # (n_virtual,)
    prev = pos[ids[:, 0]]
    curr = pos[ids[:, 1]]
    nxt = pos[ids[:, 2]]

    def unit(v):
        return v / jnp.linalg.norm(v, axis=-1, keepdims=True)

    disp = unit(unit(prev - curr) + unit(nxt - curr))
    direction = -disp
    place = curr + bond_length[:, None] * direction
    return jnp.concatenate([place, direction], axis=-1)


infer_H_O = register_node("infer_H_O", False, _infer_h_o)


def hbond_pair_strength(p, H, rHN, O, rOC):
    """Per-pair hbond strength on the (n_donor, n_acceptor) grid.

    p: (nd, na, 8) parameter rows:
       [inner_barrier, inv_inner_width, outer_barrier, inv_outer_width,
        wall_dp, inv_dp_width, 0, 0]  (hbond.cpp:153-230)
    """
    HO = H[:, None, :] - O[None, :, :]
    raw2 = jnp.sum(HO * HO, -1)
    mag2 = raw2 + 1e-6
    inv_mag = 1.0 / jnp.sqrt(mag2)
    magHO = mag2 * inv_mag
    rHO = HO * inv_mag[..., None]

    dotHOC = jnp.sum(rHO * rOC[None, :, :], -1)
    dotOHN = -jnp.sum(rHO * rHN[:, None, :], -1)

    def rsig(x):
        # reference 'sigmoid' (vector_math.h:626-631): z = exp(-x),
        # value = 1/(1+z) — the INCREASING logistic 1/(1+exp(-x)).  (The
        # C++ docstring above it claims 1/(1+exp(x)); the code disagrees,
        # and the code is what shipped.  Pinned by the hand-derived
        # fixtures in tests/test_reference_goldens.py.)
        return jax.nn.sigmoid(x)

    radial = rsig((p[..., 2] - magHO) * p[..., 3]) * \
        rsig((magHO - p[..., 0]) * p[..., 1])
    ang1 = rsig((dotHOC - p[..., 4]) * p[..., 5])
    ang2 = rsig((dotOHN - p[..., 4]) * p[..., 5])

    within = (dotHOC > 0.0) & (dotOHN > 0.0) & (raw2 < RADIAL_CUTOFF2)
    return jnp.where(within, radial * ang1 * ang2, 0.0)


def _protein_hbond(consts, params, inputs, extra):
    ho = inputs[0]  # (n_virtual, 6)
    don = ho[consts["index1"]]
    acc = ho[consts["index2"]]
    p = gather_pair_params(params["interaction_param"],
                           consts["type1"], consts["type2"])
    hb = hbond_pair_strength(p, don[:, 0:3], don[:, 3:6],
                             acc[:, 0:3], acc[:, 3:6])
    # multiplicative space: hb_log = -log(1-hb), value capped at 100 and
    # slope capped at 1e5 like the reference (hbond.cpp:221-223).  The
    # 1e-5 floor keeps the gradient finite when the sigmoid product
    # saturates to exactly 1 in float32.
    hb_log = jnp.where(hb >= 1.0, 100.0,
                       -jnp.log(jnp.maximum(1.0 - hb, 1e-5)))
    don_sum = jnp.sum(hb_log, axis=1)
    acc_sum = jnp.sum(hb_log, axis=0)
    hb_prob = 1.0 - jnp.exp(-jnp.concatenate([don_sum, acc_sum]))
    base = jnp.concatenate([don, acc], axis=0)
    return jnp.concatenate([base, hb_prob[:, None]], axis=-1)


protein_hbond = register_node("protein_hbond", False, _protein_hbond)


def _hbond_energy(consts, params, inputs, extra):
    hb = inputs[0][:, 6]
    return params["protein_hbond_energy"] * jnp.sum(hb)


hbond_energy = register_node(
    "hbond_energy", True, _hbond_energy,
    get_param=lambda c, p: np.asarray([p["protein_hbond_energy"]], np.float32),
    set_param=lambda c, p, flat: (c, {"protein_hbond_energy":
                                      jnp.asarray(float(flat[0]))}),
)


def _hbond_coverage(consts, params, inputs, extra):
    hb_nodes = inputs[0][consts["index1"]]   # (n1, 7): pos, dir, hb
    sc = inputs[1][consts["index2"]]          # (n2, >=6): pos, dir
    table = params["interaction_param"]
    ka, k, dx = quadspline_family(table.shape[-1])
    base_mask = sequence_exclusion_mask(consts["id1"], consts["id2"], 2)
    n2 = sc.shape[0]
    prefactor = (1.0 - hb_nodes[:, 6]) ** 2    # (n1,)

    if n2 > COVERAGE_NL_THRESHOLD:
        cov, idx, nmask = quadspline_coverage_nl(
            table, consts["type1"], consts["type2"],
            hb_nodes[:, 0:3], hb_nodes[:, 3:6], sc[:, 0:3], sc[:, 3:6],
            ka, k, 1.0 / dx, base_mask, COVERAGE_NEIGHBOR_K)
        val = prefactor[:, None] * cov          # (n1, K)
        safe_idx = jnp.where(nmask, idx, n2)
        out = jnp.zeros((n2 + 1,), val.dtype).at[safe_idx.reshape(-1)].add(
            jnp.where(nmask, val, 0.0).reshape(-1), mode='drop')[:n2]
        return out[:, None]

    cov = pair_coverage(table, consts["type1"], consts["type2"],
                        hb_nodes, sc, base_mask, ka, k, dx)
    val = prefactor[:, None] * cov              # (n1, n2)
    return jnp.sum(val, axis=0)[:, None]        # per-sidechain coverage


hbond_coverage = register_node("hbond_coverage", False, _hbond_coverage)
