"""Uniform cubic B-splines: device evaluation (JAX) and host-side fitting (NumPy).

The reference engine evaluates all of its tabulated potentials with uniform
cubic B-splines, in two representations:

* a *coefficient* representation evaluated with the de Boor algorithm
  (reference: src/spline.h:97-310).  Knots sit on the integer grid and the
  spline with coefficient index ``k`` is centered at ``k-1``, so an
  evaluation at coordinate ``x`` touches coefficients ``floor(x)-1 ..
  floor(x)+2``.  "Clamped" evaluation returns the constant boundary value
  (with zero derivative) for ``x<=1`` or ``x>=n_knot-2``.

* an interpolating representation where the stored parameter is the data
  table itself and a (periodic or zero-slope-clamped) interpolating spline
  is fit at load time (reference: src/spline.cpp:121-292, spline.h:396-516).

On the device we evaluate with closed-form basis polynomials (identical math
to de Boor on a uniform grid) so that every evaluation is a fused polynomial
over dense window weights — XLA vectorizes this across all residues/pairs.  Fitting
is a load-time, float64, host-side linear solve.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Basis weights (uniform cubic B-spline, t in [0,1) past the left knot)
# ---------------------------------------------------------------------------

def bspline_weights(t):
    """Weights of coefficients [i-1, i, i+1, i+2] at x = i + t."""
    s = 1.0 - t
    w0 = (1.0 / 6.0) * s * s * s
    w1 = (1.0 / 6.0) * (3.0 * t * t * t - 6.0 * t * t + 4.0)
    w2 = (1.0 / 6.0) * (-3.0 * t * t * t + 3.0 * t * t + 3.0 * t + 1.0)
    w3 = (1.0 / 6.0) * t * t * t
    return jnp.stack([w0, w1, w2, w3], axis=-1)


def bspline_dweights(t):
    """d/dx of `bspline_weights` (grid spacing 1)."""
    s = 1.0 - t
    w0 = -0.5 * s * s
    w1 = 0.5 * (3.0 * t * t - 4.0 * t)
    w2 = 0.5 * (-3.0 * t * t + 2.0 * t + 1.0)
    w3 = 0.5 * t * t
    return jnp.stack([w0, w1, w2, w3], axis=-1)


def _window_indices(x, n_knot):
    """Bin index (clipped to a valid interior window) and fractional part.

    The fractional part is computed against the *unclipped* bin so that
    callers who pre-clamp x get exact results; callers must ensure x is in
    [1, n_knot-2) for unclamped evaluation.
    """
    xb = jnp.floor(x)
    i = jnp.clip(xb.astype(jnp.int32), 1, n_knot - 3)
    t = x - i
    return i, t


def eval_bspline(coeffs, x):
    """Evaluate a uniform cubic B-spline in coefficient form.

    coeffs: (..., n_knot) — batch dims must broadcast against x
    x:      (...)         — spline coordinate, valid on [1, n_knot-2)
    Returns (value, deriv), each shaped like x.

    Matches reference deBoor_value_and_deriv (src/spline.h:97-128).
    Evaluated with dense window weights over the whole knot axis instead
    of a 4-tap take_along_axis gather: the dense multiply-reduce is cheap
    at these knot counts and fuses with the surrounding elementwise work.
    """
    n_knot = coeffs.shape[-1]
    i, t = _window_indices(x, n_knot)
    w = bspline_weights(t)
    dw = bspline_dweights(t)
    rel = jnp.arange(n_knot, dtype=jnp.int32) - i[..., None] + 1
    W = (jnp.where(rel == 0, w[..., 0:1], 0.0)
         + jnp.where(rel == 1, w[..., 1:2], 0.0)
         + jnp.where(rel == 2, w[..., 2:3], 0.0)
         + jnp.where(rel == 3, w[..., 3:4], 0.0))
    dW = (jnp.where(rel == 0, dw[..., 0:1], 0.0)
          + jnp.where(rel == 1, dw[..., 1:2], 0.0)
          + jnp.where(rel == 2, dw[..., 2:3], 0.0)
          + jnp.where(rel == 3, dw[..., 3:4], 0.0))
    cb = jnp.broadcast_to(coeffs, x.shape + (n_knot,))
    return jnp.sum(W * cb, -1), jnp.sum(dW * cb, -1)


def eval_clamped_bspline(coeffs, x):
    """Clamped evaluation: constant value / zero slope outside [1, n_knot-2].

    Matches reference clamped_deBoor_value_and_deriv (src/spline.h:268-272):
    left value = c0/6 + 2*c1/3 + c2/6, right value from the last 3 coeffs.
    """
    n_knot = coeffs.shape[-1]
    lo, hi = 1.0, float(n_knot - 2)
    xc = jnp.clip(x, lo, hi)
    val, der = eval_bspline(coeffs, xc)

    cb = jnp.broadcast_to(coeffs, x.shape + (n_knot,))
    left = (cb[..., 0] + 4.0 * cb[..., 1] + cb[..., 2]) * (1.0 / 6.0)
    right = (cb[..., -3] + 4.0 * cb[..., -2] + cb[..., -1]) * (1.0 / 6.0)

    too_small = x <= lo
    too_big = x >= hi
    val = jnp.where(too_small, left, jnp.where(too_big, right, val))
    der = jnp.where(too_small | too_big, 0.0, der)
    return val, der


def bspline_window_weights(x, n_knot, clamped=True):
    """Dense window-weight vector W (..., n_knot) with value = sum_m W_m c_m.

    A gather-free reformulation of the 4-coefficient de Boor window:
    instead of gathering coefficients at data-dependent indices, build the
    weight of EVERY knot densely — exactly 4 of the n_knot weights are
    nonzero — and contract, so per-pair spline evaluation becomes a fused
    multiply-reduce with zero gathers.  Whether a gather of the 4 live
    coefficients is cheaper on the GPU is not measured.

    For clamped splines the boundary weights are the constant
    (1/6, 2/3, 1/6) stencils of the end values, which autodiffs to the
    reference's zero boundary derivative for free.
    """
    i, t = _window_indices(x, n_knot)
    w = bspline_weights(t)                      # (..., 4)
    m = jnp.arange(n_knot, dtype=jnp.int32)
    rel = m - i[..., None]                      # (..., n_knot)
    W = (jnp.where(rel == -1, w[..., 0:1], 0.0)
         + jnp.where(rel == 0, w[..., 1:2], 0.0)
         + jnp.where(rel == 1, w[..., 2:3], 0.0)
         + jnp.where(rel == 2, w[..., 3:4], 0.0))
    if clamped:
        sixth = jnp.asarray([1 / 6, 4 / 6, 1 / 6], W.dtype)
        left = jnp.zeros((n_knot,), W.dtype).at[:3].set(sixth)
        right = jnp.zeros((n_knot,), W.dtype).at[-3:].set(sixth)
        too_small = (x <= 1.0)[..., None]
        too_big = (x >= n_knot - 2.0)[..., None]
        W = jnp.where(too_small, left, jnp.where(too_big, right, W))
    return W


def eval_bspline_dense(coeffs, x, clamped=True):
    """Gather-free spline evaluation: sum_m W_m(x) * coeffs[..., m]."""
    W = bspline_window_weights(x, coeffs.shape[-1], clamped)
    return jnp.sum(W * coeffs, axis=-1)


def eval_periodic_bspline_2d(coeffs, x, y):
    """Periodic bicubic B-spline surface evaluation.

    coeffs: (..., nx, ny) periodic B-spline coefficients (see fit below)
    x, y:   (...) in [0, nx) / [0, ny); indices wrap modulo the grid
    Returns (value, d/dx, d/dy).

    Equivalent to the reference's per-cell polynomial evaluation of the
    interpolating periodic spline (src/spline.h:434-450) when `coeffs` come
    from `fit_periodic_bspline_2d` of the same data.
    """
    nx, ny = coeffs.shape[-2], coeffs.shape[-1]
    ix = jnp.floor(x).astype(jnp.int32)
    iy = jnp.floor(y).astype(jnp.int32)
    tx = x - ix
    ty = y - iy

    # gather-free evaluation: dense periodic window weights on BOTH axes
    # and a full (nx, ny) contraction instead of a 4-row take_along_axis
    # gather; the cost of either on the GPU is not measured.
    def window(i, t, n):
        w4, dw4 = bspline_weights(t), bspline_dweights(t)
        rel = (jnp.arange(n, dtype=jnp.int32) - i[..., None] + 1) % n
        W = (jnp.where(rel == 0, w4[..., 0:1], 0.0)
             + jnp.where(rel == 1, w4[..., 1:2], 0.0)
             + jnp.where(rel == 2, w4[..., 2:3], 0.0)
             + jnp.where(rel == 3, w4[..., 3:4], 0.0))
        dW = (jnp.where(rel == 0, dw4[..., 0:1], 0.0)
              + jnp.where(rel == 1, dw4[..., 1:2], 0.0)
              + jnp.where(rel == 2, dw4[..., 2:3], 0.0)
              + jnp.where(rel == 3, dw4[..., 3:4], 0.0))
        return W, dW

    Wx, dWx = window(ix, tx, nx)                     # (..., nx)
    Wy, dWy = window(iy, ty, ny)                     # (..., ny)

    cb = jnp.broadcast_to(coeffs, x.shape + (nx, ny))
    cy = jnp.sum(cb * Wx[..., :, None], -2)          # (..., ny)
    cdx = jnp.sum(cb * dWx[..., :, None], -2)
    val = jnp.sum(cy * Wy, -1)
    ddx = jnp.sum(cdx * Wy, -1)
    ddy = jnp.sum(cy * dWy, -1)
    return val, ddx, ddy


# ---------------------------------------------------------------------------
# Host-side fitting (float64 NumPy; load-time only)
# ---------------------------------------------------------------------------

def fit_periodic_bspline_1d(data):
    """B-spline coefficients of the periodic interpolating cubic spline.

    Solves the cyclic tridiagonal system (1/6, 2/3, 1/6) * c = data
    (reference: solve_periodic_1d_spline, src/spline.cpp:121-156).
    """
    data = np.asarray(data, dtype=np.float64)
    n = data.shape[-1]
    A = np.zeros((n, n))
    idx = np.arange(n)
    A[idx, idx] = 2.0 / 3.0
    A[idx, (idx + 1) % n] = 1.0 / 6.0
    A[idx, (idx - 1) % n] = 1.0 / 6.0
    # A is symmetric, so right-multiplying by inv(A) solves along the last axis
    return data @ np.linalg.inv(A)


def fit_periodic_bspline_2d(data):
    """Tensor-product periodic interpolating bicubic spline coefficients.

    data: (..., nx, ny) -> coeffs (..., nx, ny) such that the periodic
    bicubic B-spline surface interpolates data at the integer grid.
    """
    data = np.asarray(data, dtype=np.float64)
    nx, ny = data.shape[-2], data.shape[-1]

    def inv_cyclic(n):
        A = np.zeros((n, n))
        idx = np.arange(n)
        A[idx, idx] = 2.0 / 3.0
        A[idx, (idx + 1) % n] = 1.0 / 6.0
        A[idx, (idx - 1) % n] = 1.0 / 6.0
        return np.linalg.inv(A)

    Ax = inv_cyclic(nx)
    Ay = inv_cyclic(ny)
    return np.einsum('ij,...jk,lk->...il', Ax, data, Ay)


def fit_clamped_interp_bspline(data):
    """Coefficients of the zero-slope-clamped interpolating cubic spline.

    data: (..., n) values at integer grid 0..n-1.
    Returns coeffs (..., n+2) suitable for `eval_clamped_bspline` at spline
    coordinate x+1 (so the data domain [0, n-1] maps to [1, n_knot-2]).

    Zero-slope boundary => c[0]==c[2] and c[-1]==c[-3]
    (reference: solve_clamped_1d_spline, src/spline.cpp:192-259).
    """
    data = np.asarray(data, dtype=np.float64)
    n = data.shape[-1]
    # unknowns c[1..n]; conditions: c0==c2, c[n+1]==c[n-1]
    A = np.zeros((n, n))
    idx = np.arange(n)
    A[idx, idx] = 2.0 / 3.0
    A[idx[:-1], idx[:-1] + 1] = 1.0 / 6.0
    A[idx[1:], idx[1:] - 1] = 1.0 / 6.0
    A[0, 1] += 1.0 / 6.0       # c0 -> c2 fold
    A[n - 1, n - 2] += 1.0 / 6.0  # c[n+1] -> c[n-1] fold
    inner = np.einsum('ij,...j->...i', np.linalg.inv(A), data)
    out = np.concatenate([
        inner[..., 1:2], inner, inner[..., -2:-1]], axis=-1)
    return out


def eval_clamped_interp(coeffs, x):
    """Evaluate a spline fit by `fit_clamped_interp_bspline` at data coords.

    Data domain is [0, n-1] where n = coeffs.shape[-1]-2; matches the
    reference LayeredClampedSpline1D semantics (src/spline.h:454-516):
    constant value, zero slope outside the data domain.
    """
    return eval_clamped_bspline(coeffs, x + 1.0)
