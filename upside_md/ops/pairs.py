"""Masked dense pair computations — the replacement for the reference's
cached Verlet pairlist + SIMD edge kernels (src/interaction_graph.h).

For coarse-grained proteins (hundreds of residues, <~1k interaction sites)
an O(N^2) masked computation is a small dense workload that XLA fuses and
vectorizes far better than any gather-heavy neighbor list; there is no
cache-invalidation logic and no dynamic shapes.  Exclusion predicates
become boolean masks over id arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .spline import bspline_window_weights


def sequence_exclusion_mask(id1, id2, min_sep):
    """True where the pair interacts: |id1-id2| > min_sep elementwise over
    the (n1, n2) pair grid (reference acceptable_id_pair predicates,
    e.g. interaction_graph exclusion of i,i+1,i+2)."""
    d = id1[:, None] - id2[None, :]
    return (d > min_sep) | (d < -min_sep)


def upper_triangle_mask(n):
    i = jnp.arange(n)
    return i[:, None] < i[None, :]


def pair_displacement(x1, x2):
    """disp[i,j] = x1[i] - x2[j]; returns (disp, dist2)."""
    disp = x1[:, None, :] - x2[None, :, :]
    return disp, jnp.sum(disp * disp, -1)


def safe_inv_dist(dist2, eps=0.0, mask=None):
    """rsqrt(dist2+eps) that never NaNs under masked autodiff."""
    d2 = dist2 + eps
    if mask is not None:
        d2 = jnp.where(mask, d2, 1.0)
    else:
        d2 = jnp.maximum(d2, 1e-12)
    return 1.0 / jnp.sqrt(d2)


def gather_pair_params(table, type1, type2):
    """table: (n_type1, n_type2, n_param) -> per-pair params (n1,n2,n_param).

    Built with one-hot matmuls instead of a gather; it depends only on
    parameters, never on positions, so XLA can hoist it out of MD loops."""
    oh1 = jax.nn.one_hot(type1, table.shape[0], dtype=table.dtype)
    oh2 = jax.nn.one_hot(type2, table.shape[1], dtype=table.dtype)
    # HIGHEST: an f32 dot at default precision may run in TF32 on the
    # GPU, rounding every parameter to ~1e-3 relative
    HI = jax.lax.Precision.HIGHEST
    jam = jnp.einsum('jb,abm->jam', oh2, table, precision=HI)
    return jnp.einsum('ia,jam->ijm', oh1, jam, precision=HI)


def neighbor_list(pos1, pos2, cutoff2, base_mask, K):
    """Fixed-K nearest-neighbor list over a masked pair grid.

    The replacement for the reference's cached Verlet list
    (interaction_graph.h:31-258): rebuilt every evaluation (no cache
    invalidation state), fixed shapes, exact as long as no row has more
    than K in-cutoff partners — overflow drops the *farthest* partners,
    whose kernel values are smallest.

    Returns (idx (n1,K) int32, mask (n1,K) bool).
    """
    disp = pos2[None, :, :] - pos1[:, None, :]
    d2 = jnp.sum(disp * disp, -1)
    BIG = jnp.asarray(1e30, d2.dtype)
    score = jnp.where(base_mask & (d2 < cutoff2), d2, BIG)
    neg, idx = jax.lax.top_k(-score, K)
    return idx.astype(jnp.int32), (-neg) < BIG


def quadspline_coverage_nl(p_table, t1, t2, pos1, dir1, pos2, dir2,
                           n_knot_angular, n_knot, inv_dx, base_mask, K):
    """Neighbor-list quadspline: identical values to quadspline_coverage
    but spline work is O(n1*K) instead of O(n1*n2).

    Returns (values (n1,K), idx (n1,K), mask (n1,K)).
    """
    ka, k = n_knot_angular, n_knot
    cutoff = (k - 2 - 1e-6) / inv_dx
    idx, mask = neighbor_list(pos1, pos2, cutoff * cutoff, base_mask, K)

    t2 = jnp.asarray(t2)  # consts may be numpy; indexing needs jnp under jit
    p2 = jnp.asarray(pos2)[idx]          # (n1,K,3)
    d2 = jnp.asarray(dir2)[idx]
    oh1 = jax.nn.one_hot(t1, p_table.shape[0], dtype=p_table.dtype)
    oh2 = jax.nn.one_hot(t2[idx], p_table.shape[1], dtype=p_table.dtype)
    HI = jax.lax.Precision.HIGHEST
    iam = jnp.einsum('ia,abm->ibm', oh1, p_table, precision=HI)
    p = jnp.einsum('ikb,ibm->ikm', oh2, iam, precision=HI)  # (n1, K, m)

    disp = p2 - pos1[:, None, :]
    dist2 = jnp.sum(disp * disp, -1)
    inv_dist = safe_inv_dist(dist2, mask=mask)
    dist_coord = dist2 * inv_dist * inv_dx
    u = disp * inv_dist[..., None]
    cos1 = jnp.sum(dir1[:, None, :] * u, -1)
    cos2 = -jnp.sum(d2 * u, -1)
    inv_dtheta = (ka - 3) / 2.0

    def seg_eval(x, lo, hi, clamped):
        W = bspline_window_weights(x, hi - lo, clamped)
        return jnp.sum(W * p[..., lo:hi], -1)

    a1 = seg_eval((cos1 + 1.0) * inv_dtheta + 1.0, 0, ka, False)
    a2 = seg_eval((cos2 + 1.0) * inv_dtheta + 1.0, ka, 2 * ka, False)
    wide = seg_eval(dist_coord, 2 * ka, 2 * ka + k, True)
    narrow = seg_eval(dist_coord, 2 * ka + k, 2 * ka + 2 * k, True)

    cov = jnp.where(mask, wide + a1 * a2 * narrow, 0.0)
    return cov, idx, mask


def scatter_rows(values, idx, mask, n2):
    """Scatter (n1,K) neighbor values back to a dense (n1,n2) grid."""
    n1, K = values.shape
    safe_idx = jnp.where(mask, idx, n2)  # out-of-range drops in .at[]
    dense = jnp.zeros((n1, n2 + 1), values.dtype)
    dense = dense.at[jnp.arange(n1)[:, None], safe_idx].add(
        jnp.where(mask, values, 0.0), mode='drop')
    return dense[:, :n2]


def pair_coverage(table, t1, t2, feats1, feats2, base_mask, ka, k, dx):
    """Dense masked pair-spline values (n1, n2) in the fused dense-window
    formulation.  feats: (n, >=6) rows of site pos+dir."""
    p = gather_pair_params(jnp.asarray(table), jnp.asarray(t1),
                           jnp.asarray(t2))
    disp = feats2[None, :, 0:3] - feats1[:, None, 0:3]
    dist2 = jnp.sum(disp * disp, -1)
    cutoff = (k - 2 - 1e-6) * dx
    mask = base_mask & (dist2 < cutoff * cutoff)
    return quadspline_coverage(p, feats1[:, 0:3], feats1[:, 3:6],
                               feats2[:, 0:3], feats2[:, 3:6],
                               ka, k, 1.0 / dx, mask)


def quadspline_family(n_param):
    """Infer (n_knot_angular, n_knot, dx) of a directional-bead spline table
    from its parameter count.  The reference hard-codes these families at
    compile time (src/bead_interaction.h:12-27, an acknowledged FIXME); the
    three shipped families have distinct n_param = 2*ka + 2*k, so the table
    shape determines the family at runtime."""
    families = {
        2 * 8 + 2 * 9: (8, 9, 1.0),     # default: SC_SC
        2 * 8 + 2 * 7: (8, 7, 1.0),     # default: SC_BB
        2 * 15 + 2 * 16: (15, 16, 0.5),  # PARAM_7A_CUTOFF: SC_SC
        2 * 15 + 2 * 12: (15, 12, 0.5),  # PARAM_7A_CUTOFF: SC_BB
        2 * 8 + 2 * 12: (8, 12, 1.0),   # PARAM_10A_CUTOFF: SC_SC and SC_BB
    }
    if n_param not in families:
        raise ValueError(f"cannot infer quadspline family from n_param={n_param}")
    return families[n_param]


@jax.named_scope("pair_spline")   # names the kernels in profiler traces
def quadspline_coverage(p, pos1, dir1, pos2, dir2,
                        n_knot_angular, n_knot, inv_dx, mask):
    """Directional bead-pair kernel (reference quadspline,
    src/bead_interaction.h:30-84).

    p: (n1, n2, 2*ka + 2*k) per-pair spline tables
    pos/dir: (n, 3) point + unit direction per bead
    Returns coverage (n1, n2) = wide(r) + ang1*ang2*narrow(r), masked.
    """
    ka, k = n_knot_angular, n_knot
    disp = pos2[None, :, :] - pos1[:, None, :]  # x2 - x1, shape (n1, n2, 3)
    dist2 = jnp.sum(disp * disp, -1)
    inv_dist = safe_inv_dist(dist2, mask=mask)
    dist_coord = dist2 * inv_dist * inv_dx
    u = disp * inv_dist[..., None]

    cos1 = jnp.sum(dir1[:, None, :] * u, -1)
    cos2 = -jnp.sum(dir2[None, :, :] * u, -1)
    inv_dtheta = (ka - 3) / 2.0

    # gather-free spline evaluation: dense window weights over the knot
    # axis, contracted against the (position-independent) per-pair
    # parameter rows — elementwise work, no data-dependent gathers.  Each
    # segment is its own multiply-reduce so XLA fuses the weight
    # construction into the reduction loop instead of materializing
    # (n1,n2,n_param) tensors.
    def seg_eval(x, lo, hi, clamped):
        W = bspline_window_weights(x, hi - lo, clamped)
        return jnp.sum(W * p[..., lo:hi], -1)

    a1 = seg_eval((cos1 + 1.0) * inv_dtheta + 1.0, 0, ka, False)
    a2 = seg_eval((cos2 + 1.0) * inv_dtheta + 1.0, ka, 2 * ka, False)
    wide = seg_eval(dist_coord, 2 * ka, 2 * ka + k, True)
    narrow = seg_eval(dist_coord, 2 * ka + k, 2 * ka + 2 * k, True)

    cov = wide + a1 * a2 * narrow
    return jnp.where(mask, cov, 0.0)
