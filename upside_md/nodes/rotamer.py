"""Side-chain rotamer free energy via loopy belief propagation.

Reference: src/rotamer.cpp (1082 LoC of SIMD message passing over a
hand-built sparse edge hash).  Dense redesign:

* Every residue is padded to MAX_ROT=6 rotamer slots with a validity mask;
  there are no 1/3/6-rotamer node classes and no edge hash.
* Bead-pair energies (the directional quadspline kernel of
  src/bead_interaction.h) are computed on the dense bead grid and
  scattered into residue-pair 6x6 blocks with two one-hot matmuls.
* BP messages are one batched multiply-reduce over the dense
  (n_res, n_res, 6, 6) edge-potential tensor per iteration, inside one
  lax.while_loop; non-edges carry identity potentials
  and provably do not move the fixed point.
* The solve runs inside stop_gradient; the returned potential is the Bethe
  free energy written as an explicit function of the (stopped) marginals
  and the (differentiable) energies.  jax.grad then reproduces exactly the
  reference's envelope-theorem derivative: edge sensitivity = pair
  marginal, 1-body sensitivity = node marginal (rotamer.cpp:956-985).

The padded-class trick mirrors how the reference already splits 1/3/6-rot
NodeHolders; folding 1-rotamer residues into their neighbors (reference
move_edge_prob_to_node2) is unnecessary here because a 1-rot node's belief
is pinned by its mask and its messages act as the same constant field.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.pairs import (quadspline_coverage_nl, quadspline_family,
                         scatter_rows)
from .base import register_node

MAX_ROT = 6
EPS = 1e-10
# beads beyond this count switch the pair kernel to a fixed-K neighbor
# list; K must exceed the worst-case in-cutoff partner count.  The
# crossover against the masked dense grid (top_k + row gathers vs O(N^2)
# spline work) is not measured on the GPU; the NL only engages for large
# multi-chain systems.
NEIGHBOR_LIST_THRESHOLD = 1024
NEIGHBOR_K = 128


def decode_bead_ids(packed_ids, n_bit_rotamer=4):
    """Packed bead id -> (rot, n_rot, residue) bit fields
    (reference rotamer.cpp:565-577, bead_interaction.h:131)."""
    packed_ids = np.asarray(packed_ids, np.int64)
    sel = (1 << n_bit_rotamer) - 1
    rot = packed_ids & sel
    n_rot = (packed_ids >> n_bit_rotamer) & sel
    res = packed_ids >> (2 * n_bit_rotamer)
    return rot.astype(np.int32), n_rot.astype(np.int32), res.astype(np.int32)


def _bp_solve(prob, P, adj, valid, damping, max_iter, tol, chunk=2,
              init=None):
    """Damped synchronous loopy BP on the dense residue grid.

    prob:  (R, 6)        unnormalized node potentials (zero at invalid slots)
    P:     (R, R, 6, 6)  pairwise Boltzmann factors, P[i,j,a,b]=exp(-E2[i,j,a,b])
    adj:   (R, R) bool   which pairs are real edges (diagonal False)
    valid: (R, 6) bool   rotamer-slot validity
    init:  optional (nb0 (R,6), eb0 (R,R,6)) warm-start beliefs; BP
           converges to the same fixed point from any positive init, so a
           warm start (e.g. the previous MD step's messages) only changes
           the iteration count, never the answer beyond `tol`.
    Returns (node_belief (R,6) l1-normalized, edge_belief (R,R,6),
    deviation, sweeps): the last checked sweep's max belief change and
    the number of sweeps run.  deviation > tol means the solve stopped
    at max_iter without converging.

    Matches the reference solve_for_marginals schedule
    (rotamer.cpp:988-1061): beliefs start from the bare probabilities, the
    first sweep is undamped, subsequent sweeps mix with `damping`.
    """
    R = prob.shape[0]
    adf = adj[..., None].astype(prob.dtype)

    def edge_update(nb_for_v, eb):
        # V[i,j,:] = nb[i]/(eps+eb[i,j,:]); message into i from j:
        # eb_new[i,j,a] = sum_b P[i,j,a,b] * V[j,i,b].
        # Written as an elementwise multiply-reduce instead of an einsum:
        # a batched 6x6 dot_general is far too small for a matrix unit,
        # and the multiply-reduce fuses with the normalization below.
        V = nb_for_v[:, None, :] / (EPS + eb)
        VT = jnp.swapaxes(V, 0, 1)                    # VT[i,j,b] = V[j,i,b]
        m = jnp.sum(P * VT[:, :, None, :], axis=-1)   # (R,R,6)
        m = jnp.where(valid[:, None, :], m, 0.0)
        norm = jnp.sum(m, axis=-1, keepdims=True)
        m = m / jnp.maximum(norm, EPS)
        return jnp.where(adj[..., None], m, 1.0)

    def node_update(eb):
        # product over edges in log space (masked), max-centered before
        # exp so high-degree nodes cannot underflow f32 (the constant
        # cancels in the max-normalization)
        s = jnp.sum(jnp.log(jnp.maximum(eb, 1e-30)) * adf, axis=1)
        s = s - jnp.max(s, axis=-1, keepdims=True)
        nb = prob * jnp.exp(s)
        return nb / jnp.maximum(jnp.max(nb, axis=-1, keepdims=True), EPS)

    if init is None:
        # initial sweep (undamped; reference calculate_new_beliefs(0, true))
        eb0 = edge_update(prob, jnp.ones((R, R, MAX_ROT), prob.dtype))
        nb0 = prob / jnp.maximum(jnp.max(prob, -1, keepdims=True), EPS)
    else:
        nb0, eb0 = (jnp.asarray(init[0], prob.dtype),
                    jnp.asarray(init[1], prob.dtype))
        # the cache stores sum-normalized beliefs but the sweep loop is
        # max-normalized; rescale so the damping mix doesn't see a purely
        # notational deviation (costs ~2 chunks of sweeps otherwise)
        nb0 = nb0 / jnp.maximum(jnp.max(nb0, -1, keepdims=True), EPS)

    def cond(state):
        _, _, it, dev = state
        return (it < max_iter) & (dev > tol)

    def body(state):
        nb, eb, it, _ = state
        # several sweeps per convergence check (the reference's
        # iteration_chunk_size, rotamer.cpp:1038-1046) — halves the
        # while-loop condition overhead
        for _ in range(chunk):
            nb_prev = nb
            eb = edge_update(nb, eb)
            nb_new = node_update(eb)
            nb = (1.0 - damping) * nb_new + damping * nb
        dev = jnp.max(jnp.abs(nb - nb_prev))
        return nb, eb, it + chunk, dev

    # the scope names the solve's kernels in profiler traces
    with jax.named_scope("bp_solve"):
        nb, eb, iters, dev = jax.lax.while_loop(
            cond, body,
            (nb0, eb0, jnp.asarray(0), jnp.asarray(jnp.inf, prob.dtype)))

    nb = nb / jnp.maximum(jnp.sum(nb, -1, keepdims=True), EPS)
    return nb, eb, dev, iters


def bethe_free_energy(E1, offset, P, adj, valid, node_marg, edge_belief):
    """Bethe free energy as an explicit function of the energies with the
    marginals held constant (envelope form).

    node term (rotamer.cpp:292-302):
        offset_r + sum_o b log((eps+b)/(eps+exp(offset-E1)))
    edge term (rotamer.cpp:431-451), i<j real edges:
        sum_ab m log((eps+m)/(eps+P*b_i*b_j))
    """
    b = jax.lax.stop_gradient(node_marg)
    pr = jnp.where(valid, jnp.exp(offset[:, None] - E1), 0.0)
    node_en = offset + jnp.sum(
        jnp.where(valid, b * jnp.log((EPS + b) / (EPS + pr)), 0.0), axis=-1)

    eb = jax.lax.stop_gradient(edge_belief)
    bc1 = b[:, None, :] / (EPS + eb)                 # (R,R,6) node i at edge ij
    bc2 = jnp.swapaxes(bc1, 0, 1)                    # node j at edge ij
    m_raw = P * bc1[:, :, :, None] * bc2[:, :, None, :]
    m_norm = jnp.maximum(jnp.sum(m_raw, axis=(-1, -2), keepdims=True), EPS)
    m = jax.lax.stop_gradient(m_raw / m_norm)

    pbb = P * b[:, None, :, None] * b[None, :, None, :]
    pair_valid = valid[:, None, :, None] & valid[None, :, None, :]
    edge_en = jnp.sum(
        jnp.where(pair_valid, m * jnp.log((EPS + m) / (EPS + pbb)), 0.0),
        axis=(-1, -2))

    iu = jnp.triu(adj, 1)  # count each edge once
    return jnp.sum(node_en) + jnp.sum(jnp.where(iu, edge_en, 0.0))


def assemble_one_body(consts, params, inputs):
    """Bead geometry rows + the padded 1-body energy table.

    Returns (x (n_bead, >=6), E1 (R,6), offset (R,), prob (R,6), valid)."""
    beads = inputs[0]                       # bead pos+dir node (n, >=6)
    prob_nodes = inputs[1:]                 # 1-body energies, each (n, 1)
    idx = consts["index"]                   # bead -> row in pos node
    x = beads[idx]
    n_res = int(consts["n_res"])
    valid = jnp.asarray(consts["valid"])    # (n_res, 6) bool
    onehot = jnp.asarray(consts["onehot"], x.dtype)      # (n_bead, n_res*6)

    if prob_nodes and all(pn.shape == prob_nodes[0].shape
                          for pn in prob_nodes):
        # fold the bead gather into the rot-slot scatter: one static
        # matrix G[(ri,a), row] = sum_{n: idx[n]=row} onehot[n, ri*6+a]
        # turns gather + scatter-add into a single matvec.  HIGHEST: an
        # f32 dot at default precision may run in TF32 on the GPU, which
        # would round every 1-body energy to ~1e-3 relative
        n_rows = prob_nodes[0].shape[0]
        G = np.zeros((n_res * MAX_ROT, n_rows), np.float32)
        np.add.at(G, (np.argmax(consts["onehot"], axis=1),
                      np.asarray(idx)), 1.0)
        e_rows = prob_nodes[0][:, 0]
        for pn in prob_nodes[1:]:
            e_rows = e_rows + pn[:, 0]
        E1 = jnp.dot(jnp.asarray(G, x.dtype), e_rows,
                     precision=jax.lax.Precision.HIGHEST)
        E1 = E1.reshape(n_res, MAX_ROT)
    else:
        e_bead = jnp.zeros((x.shape[0],), x.dtype)
        for pn in prob_nodes:
            e_bead = e_bead + pn[idx, 0]
        E1 = jnp.dot(e_bead, onehot, precision=jax.lax.Precision.HIGHEST)
        E1 = E1.reshape(n_res, MAX_ROT)
    offset = jnp.min(jnp.where(valid, E1, jnp.inf), axis=-1)
    prob = jnp.where(valid, jnp.exp(offset[:, None] - E1), 0.0)
    return x, E1, offset, prob, valid


def assemble_pair_grid(consts, params, x):
    """Dense (n_bead, n_bead) pair-energy grid, each unordered pair counted
    once (upper triangle, different residues — the reference pairlist
    builds b1<b2 edges, rotamer.cpp:793-852).

    Returns (E_pair, pair_mask)."""
    table = params["interaction_param"]
    ka, k, dx = quadspline_family(table.shape[-1])
    res = consts["res"]
    n_bead = x.shape[0]
    cutoff = (k - 2 - 1e-6) * dx
    triangle = jnp.arange(n_bead)[:, None] < jnp.arange(n_bead)[None, :]
    base_mask = triangle & (res[:, None] != res[None, :])
    if n_bead > NEIGHBOR_LIST_THRESHOLD:
        cov, idx, nmask = quadspline_coverage_nl(
            table, consts["type"], consts["type"], x[:, 0:3], x[:, 3:6],
            x[:, 0:3], x[:, 3:6], ka, k, 1.0 / dx, base_mask,
            min(n_bead, NEIGHBOR_K))
        E_pair = scatter_rows(cov, idx, nmask, n_bead)
        pair_mask = scatter_rows(jnp.where(nmask, 1.0, 0.0), idx, nmask,
                                 n_bead) > 0
    else:
        disp = x[None, :, 0:3] - x[:, None, 0:3]
        dist2 = jnp.sum(disp * disp, -1)
        pair_mask = base_mask & (dist2 < cutoff * cutoff)
        from ..ops.pairs import pair_coverage
        E_pair = pair_coverage(table, consts["type"], consts["type"],
                               x, x, base_mask, ka, k, dx)
    return E_pair, pair_mask


def assemble_rotamer_energies(consts, params, inputs):
    """Build the padded residue-level BP problem from bead geometry.

    Returns (E1 (R,6), offset (R,), prob (R,6), E2 (R,R,6,6), adj, valid) —
    the reference builds the same data into its Node/EdgeHolders
    (rotamer.cpp fill_holders, :793-852).  E2 is the symmetrized pair
    energy; the Boltzmann factor P = exp(-E2) is formed by the solver."""
    x, E1, offset, prob, valid = assemble_one_body(consts, params, inputs)
    n_res = int(consts["n_res"])
    onehot = jnp.asarray(consts["onehot"], x.dtype)      # (n_bead, n_res*6)
    onehot_res = jnp.asarray(consts["onehot_res"], x.dtype)  # (n_bead, n_res)
    E_pair, pair_mask = assemble_pair_grid(consts, params, x)

    # scatter to (R*6, R*6) with two one-hot matmuls at HIGHEST
    # precision: the scatter must be exact in f32.  An f32 dot at default
    # precision may run in TF32 on the GPU, and rounding the pair
    # energies is amplified through exp(-E2) on clash-scale energies and
    # measurably moves the BP fixed point on frustrated problems.
    HI = jax.lax.Precision.HIGHEST
    half = jax.lax.dot(onehot.T, E_pair.astype(onehot.dtype), precision=HI,
                       preferred_element_type=jnp.float32)
    E2u = jax.lax.dot(half.astype(onehot.dtype), onehot, precision=HI,
                      preferred_element_type=jnp.float32).astype(x.dtype)
    E2u = E2u.reshape(n_res, MAX_ROT, n_res, MAX_ROT)
    E2u = jnp.transpose(E2u, (0, 2, 1, 3))    # (R, R, 6, 6)
    E2 = E2u + jnp.transpose(E2u, (1, 0, 3, 2))
    adjf = onehot_res.T @ pair_mask.astype(x.dtype) @ onehot_res
    adj = ((adjf + adjf.T) > 0) & ~jnp.eye(n_res, dtype=bool)
    return E1, offset, prob, E2, adj, valid


class BPCache(NamedTuple):
    """Warm-start state of one rotamer node, threaded through the MD loop
    by System.energy_and_cache (one per replica in a batched state).

    The prev_* fields hold the previous evaluation's beliefs for warm-start
    extrapolation (UPSIDE_BP_EXTRAP) and are None in the modes that keep
    no such history.  `deviation` and `sweeps` are the last solve's final
    belief change and sweep count; deviation > tol is the reference's
    n_bad_solve signal (rotamer.cpp:657-659)."""
    node_belief: jnp.ndarray               # (R, 6)
    edge_belief: jnp.ndarray               # (R, R, 6)
    prev_node_belief: Optional[jnp.ndarray]
    prev_edge_belief: Optional[jnp.ndarray]
    deviation: jnp.ndarray                 # () float32
    sweeps: jnp.ndarray                    # () int32


def bp_solve_health(cache_entry):
    """(final deviation, sweep count) of the last BP solve recorded in a
    rotamer cache entry, as numpy arrays (one value per replica for a
    batched state), or None for any other cache entry."""
    if not isinstance(cache_entry, BPCache):
        return None
    return np.asarray(cache_entry.deviation), np.asarray(cache_entry.sweeps)


def _extrap_cfg():
    """UPSIDE_BP_EXTRAP: "<alpha>" extrapolates node beliefs AND edge
    messages; "nb:<alpha>" node beliefs only; "off" keeps the plain warm
    start.  nb-only keeps most of the sweep savings while the cache
    history stays one (R, 6) belief array per replica
    (tools/bp_extrap_exp.py measures the sweep counts)."""
    import os
    # default: nb-only linear log-space extrapolation; quadratic (3-point)
    # extrapolation amplifies noise across thermostat kicks
    v = os.environ.get("UPSIDE_BP_EXTRAP", "nb:1.0")
    if not v or v.lower() in ("0", "off", "none"):
        return None
    if v.startswith("nb:"):
        return (float(v[3:]), "nb")
    return (float(v), "both")


def _extrapolate_beliefs(last, prev, alpha):
    """Warm-start init extrapolated (log-space) from the last TWO force
    evaluations' converged beliefs: m = m1 * (m1/m0)^alpha, clipped.

    Positions move by O(dt/3) between evaluations, so the beliefs drift
    smoothly; starting from the extrapolation instead of the last value
    cuts the sweep count (tools/bp_extrap_exp.py).  BP converges to the
    same fixed point from any positive init, so this changes only the
    iteration count, never the answer beyond tol.  Layout: nb (R, 6),
    eb (R, R, 6); passing the same eb object twice extrapolates the node
    beliefs only."""
    nb1, eb1 = last
    nb0, eb0 = prev

    def ex(m1, m0):
        r = jnp.clip(m1 / jnp.maximum(m0, 1e-12), 0.1, 10.0)
        m = m1 * r ** alpha
        return jnp.where(m1 > 0, jnp.maximum(m, 1e-8), jnp.zeros_like(m1))

    nbx = ex(nb1, nb0)
    nbx = nbx / jnp.maximum(jnp.max(nbx, -1, keepdims=True), EPS)

    if eb1 is eb0:     # nb-only mode: messages pass through untouched
        return nbx, eb1
    eb = ex(eb1, eb0)
    # renormalize each extrapolated message across its rotamer-slot axis;
    # messages that did not move between the two steps — non-edges pinned
    # at 1.0, or converged-identical edges — keep their stored value
    s = jnp.sum(eb, axis=-1, keepdims=True)
    moved = jnp.any(eb1 != eb0, axis=-1, keepdims=True)
    eb = jnp.where(moved, eb / jnp.maximum(s, EPS), eb1)
    return nbx, eb


def _solve_damping(consts):
    """Solver damping: the config's value, unless overridden.

    Damping shapes the convergence path, never the fixed point, so an
    override changes iteration counts only (tools/bp_damping_exp.py
    compares warm-started production solves across dampings).
    UPSIDE_BP_DAMPING applies to every solve; configs keep their stored
    attribute for reference parity."""
    import os
    v = os.environ.get("UPSIDE_BP_DAMPING")
    return float(v) if v else float(consts["damping"])


def _solve_chunk(consts):
    """Convergence-check cadence (sweeps between tolerance tests,
    reference iteration_chunk_size rotamer.cpp:1038-1046).  Schedule
    only — overshooting the fixed point by up to chunk-1 sweeps never
    changes it.  UPSIDE_BP_CHUNK overrides for A/B sessions."""
    import os
    v = os.environ.get("UPSIDE_BP_CHUNK")
    # clamp to >= 1: chunk 0 would make the solve body run zero sweeps
    # between checks, which is meaningless and trips the loop carry
    return max(1, int(v)) if v else max(
        1, int(consts.get("iteration_chunk_size", 2)))


def _warm_start(cached, extrap):
    """Solver init from a BPCache: the last beliefs, extrapolated when the
    entry carries history for the configured mode."""
    init = (cached.node_belief, cached.edge_belief)
    if extrap is None or cached.prev_node_belief is None:
        return init
    prev_eb = cached.prev_edge_belief
    if extrap[1] == "nb" or prev_eb is None:
        prev_eb = cached.edge_belief      # messages pass through
    return _extrapolate_beliefs(init, (cached.prev_node_belief, prev_eb),
                                extrap[0])


def _rotamer(consts, params, inputs, extra):
    # warm-start messages threaded through the MD loop (cache protocol of
    # System.energy_and_cache); BP converges to the same fixed point from
    # any init, so this only cuts iterations
    extra = extra or {}
    name = extra.get("_node_name")
    cached = extra.get("_cache", {}).get(name)
    cache_out = extra.get("_cache_out")
    extrap = _extrap_cfg()

    E1, offset, prob, E2, adj, valid = assemble_rotamer_energies(
        consts, params, inputs)
    P = jnp.exp(-E2)
    # solve (constant w.r.t. autodiff) and assemble the Bethe energy
    nb, eb, dev, sweeps = _bp_solve(
        jax.lax.stop_gradient(prob), jax.lax.stop_gradient(P), adj, valid,
        _solve_damping(consts), consts["max_iter"], consts["tol"],
        _solve_chunk(consts),
        init=None if cached is None else _warm_start(cached, extrap))
    if cache_out is not None and name is not None:
        # stored in f32 so the cache pytree keeps a stable structure in
        # lax.fori_loop carries regardless of the x64 mode
        nb32 = jax.lax.stop_gradient(nb).astype(jnp.float32)
        eb32 = jax.lax.stop_gradient(eb).astype(jnp.float32)
        prev_nb = prev_eb = None
        if extrap is not None:
            # history: the previous evaluation's raw solution
            prev_nb = nb32 if cached is None else cached.node_belief
            if extrap[1] == "both":
                prev_eb = eb32 if cached is None else cached.edge_belief
        cache_out[name] = BPCache(nb32, eb32, prev_nb, prev_eb,
                                  dev.astype(jnp.float32),
                                  sweeps.astype(jnp.int32))
    return bethe_free_energy(E1, offset, P, adj, valid, nb, eb)


def _rot_init_cache(consts, params):
    """Initial warm-start messages: uniform beliefs, identity edge
    messages.  These are a valid BP starting point (the reference's cold
    start normalizes away the difference in its first sweep), so the first
    cached evaluation matches the cold answer to the solver tolerance."""
    n_res = int(consts["n_res"])
    nb = jnp.asarray(np.asarray(consts["valid"]), jnp.float32)
    eb = jnp.ones((n_res, n_res, MAX_ROT), jnp.float32)
    extrap = _extrap_cfg()
    # (last, prev) history starts equal
    return BPCache(nb, eb,
                   nb if extrap is not None else None,
                   eb if extrap is not None and extrap[1] == "both"
                   else None,
                   jnp.asarray(0.0, jnp.float32), jnp.asarray(0, jnp.int32))


def _rot_get_param(c, p):
    return np.asarray(p["interaction_param"]).ravel()


def _rot_set_param(c, p, flat):
    shape = np.asarray(p["interaction_param"]).shape
    q = dict(p)
    q["interaction_param"] = jnp.asarray(
        np.asarray(flat, np.float32).reshape(shape))
    return c, q


rotamer = register_node("rotamer", True, _rotamer,
                        get_param=_rot_get_param, set_param=_rot_set_param,
                        init_cache=_rot_init_cache)


def make_rotamer_consts(packed_ids, index, types, damping, max_iter, tol):
    """Build the static scatter/mask structures from packed bead ids.

    NOTE: the packed residue field is a counter *within* each
    rotamer-count class (upside_config.py:973-983 count_by_n_rot), so the
    BP node key is the (n_rot, count) pair — two residues in different
    classes share count values."""
    rot, n_rot, res = decode_bead_ids(packed_ids)
    key = res.astype(np.int64) * (1 << 4) + n_rot
    uniq, res_c = np.unique(key, return_inverse=True)
    res_c = res_c.astype(np.int32)
    n_res = len(uniq)
    n_rot_per_res = np.zeros(n_res, np.int32)
    n_rot_per_res[res_c] = n_rot
    valid = np.arange(MAX_ROT)[None, :] < n_rot_per_res[:, None]

    n_bead = len(rot)
    onehot = np.zeros((n_bead, n_res * MAX_ROT), np.float32)
    onehot[np.arange(n_bead), res_c * MAX_ROT + rot] = 1.0
    onehot_res = np.zeros((n_bead, n_res), np.float32)
    onehot_res[np.arange(n_bead), res_c] = 1.0

    return {
        "index": np.asarray(index, np.int32),
        "type": np.asarray(types, np.int32),
        "rot": rot, "res": res_c, "n_res": n_res,
        "n_rot_per_res": n_rot_per_res,
        "valid": valid, "onehot": onehot, "onehot_res": onehot_res,
        "damping": float(damping), "max_iter": int(max_iter),
        "tol": float(tol),
    }


def rotamer_diagnostics(consts, params, inputs):
    """Diagnostics matching the reference's get_value_by_name channels
    (rotamer.cpp:675-773): per-residue free energies, 1-body energies,
    node/edge energies and marginals."""
    E1, offset, prob, E2, adj, valid = assemble_rotamer_energies(
        consts, params, inputs)
    P = jnp.exp(-E2)
    nb, eb, _, _ = _bp_solve(prob, P, adj, valid, consts["damping"],
                             consts["max_iter"], consts["tol"])

    pr = jnp.where(valid, jnp.exp(offset[:, None] - E1), 0.0)
    node_en = offset + jnp.sum(
        jnp.where(valid, nb * jnp.log((EPS + nb) / (EPS + pr)), 0.0), -1)

    bc1 = nb[:, None, :] / (EPS + eb)
    bc2 = jnp.swapaxes(bc1, 0, 1)
    m_raw = P * bc1[:, :, :, None] * bc2[:, :, None, :]
    m = m_raw / jnp.maximum(jnp.sum(m_raw, (-1, -2), keepdims=True), EPS)
    pbb = P * nb[:, None, :, None] * nb[None, :, None, :]
    pair_valid = valid[:, None, :, None] & valid[None, :, None, :]
    edge_en = jnp.sum(jnp.where(pair_valid,
                                m * jnp.log((EPS + m) / (EPS + pbb)), 0.0),
                      (-1, -2))
    edge_en = jnp.where(adj, edge_en, 0.0)

    residue_fe = node_en + 0.5 * jnp.sum(edge_en, axis=1)
    bead_marg = nb.reshape(-1)[consts["res"] * MAX_ROT + consts["rot"]]
    return {
        "node_marginal": nb,
        "edge_marginal": jnp.where(adj[:, :, None, None], m, 0.0),
        "node_energy": jnp.where(valid, E1, 1e5),
        "edge_energy": -jnp.log(jnp.where(adj[:, :, None, None], P, 1.0)),
        "node_free_energy": node_en,
        "edge_free_energy": edge_en,
        "rotamer_free_energy": residue_fe,
        "bead_marginal": bead_marg,
        "adjacency": adj,
    }


def rotamer_1body_energy(consts, params, inputs, prob_node_index):
    """Marginal-weighted 1-body energy per residue for one prob node
    (rotamer.cpp:904-926)."""
    diag = rotamer_diagnostics(consts, params, inputs)
    nb = diag["node_marginal"]
    idx = consts["index"]
    e_bead = inputs[1 + prob_node_index][idx, 0]
    w = nb.reshape(-1)[consts["res"] * MAX_ROT + consts["rot"]]
    onehot_res = jnp.asarray(consts["onehot_res"], e_bead.dtype)
    return (w * e_bead) @ onehot_res


def rotamer_marginals(consts, params, inputs):
    """Posterior node marginals per bead (for chi1 prediction diagnostics).

    Returns (node_marginals (n_res, 6), per-bead marginal (n_bead,))."""
    _, _, prob, E2, adj, valid = assemble_rotamer_energies(
        consts, params, inputs)
    nb, _, _, _ = _bp_solve(prob, jnp.exp(-E2), adj, valid,
                            consts["damping"], consts["max_iter"],
                            consts["tol"])
    bead_marg = nb.reshape(-1)[consts["res"] * MAX_ROT + consts["rot"]]
    return nb, bead_marg
