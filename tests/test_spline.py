"""Spline math validated against scipy's (unique) interpolating splines."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.interpolate import CubicSpline

from upside_md.ops.spline import (
    eval_bspline, eval_clamped_bspline, eval_periodic_bspline_2d,
    eval_clamped_interp, fit_clamped_interp_bspline,
    fit_periodic_bspline_1d, fit_periodic_bspline_2d)


def test_bspline_partition_of_unity():
    c = np.ones(10)
    x = np.linspace(1.0, 7.999, 37)
    v, d = eval_bspline(jnp.asarray(c), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(v), 1.0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(d), 0.0, atol=1e-12)


def test_bspline_interpolation_identity(rng):
    # at integer x=i the value is (c[i-1] + 4c[i] + c[i+1])/6
    c = rng.normal(size=12)
    for i in range(1, 10):
        v, _ = eval_bspline(jnp.asarray(c), jnp.asarray(float(i)))
        assert abs(float(v) - (c[i - 1] + 4 * c[i] + c[i + 1]) / 6) < 1e-12


def test_bspline_matches_scipy_bspline(rng):
    from scipy.interpolate import BSpline
    c = rng.normal(size=14)
    n = len(c)
    # coefficient k is a cubic B-spline centered at k-1 -> support [k-3, k+1]
    spl = BSpline(np.arange(-2, n + 2), c, 3)
    x = rng.uniform(1.0, n - 2.0 - 1e-6, size=50)
    v, d = eval_bspline(jnp.asarray(c), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(v), spl(x), atol=1e-10)
    np.testing.assert_allclose(np.asarray(d), spl.derivative()(x), atol=1e-9)


def test_clamped_bspline_boundaries(rng):
    c = rng.normal(size=9)
    v_lo, d_lo = eval_clamped_bspline(jnp.asarray(c), jnp.asarray(0.3))
    v_hi, d_hi = eval_clamped_bspline(jnp.asarray(c), jnp.asarray(8.5))
    assert abs(float(v_lo) - (c[0] + 4 * c[1] + c[2]) / 6) < 1e-12
    assert abs(float(v_hi) - (c[-3] + 4 * c[-2] + c[-1]) / 6) < 1e-12
    assert float(d_lo) == 0.0 and float(d_hi) == 0.0


def test_periodic_fit_interpolates(rng):
    data = rng.normal(size=18)
    c = fit_periodic_bspline_1d(data)
    for i in range(18):
        window = np.array([c[(i - 1) % 18], c[i], c[(i + 1) % 18]])
        assert abs(window @ [1 / 6, 2 / 3, 1 / 6] - data[i]) < 1e-10


def test_periodic_2d_matches_scipy_tensor_product(rng):
    nx, ny = 10, 12
    data = rng.normal(size=(nx, ny))
    coeffs = fit_periodic_bspline_2d(data)

    # scipy periodic cubic interpolant is the same unique C2 function;
    # compare on a line of random points via nested 1D periodic splines
    xg = np.arange(nx + 1.0)
    yg = np.arange(ny + 1.0)
    data_x = np.concatenate([data, data[:1]], 0)

    pts_x = rng.uniform(0, nx, 25)
    pts_y = rng.uniform(0, ny, 25)

    # interpolate along x for each y column, then along y
    expected = []
    for px, py in zip(pts_x, pts_y):
        col = CubicSpline(xg, data_x, bc_type='periodic', axis=0)(px)
        col_p = np.concatenate([col, col[:1]])
        expected.append(CubicSpline(yg, col_p, bc_type='periodic')(py))
    expected = np.array(expected)

    v, dx, dy = eval_periodic_bspline_2d(
        jnp.asarray(coeffs), jnp.asarray(pts_x), jnp.asarray(pts_y))
    np.testing.assert_allclose(np.asarray(v), expected, atol=1e-8)

    # derivative check by finite differences
    eps = 1e-6
    vp, _, _ = eval_periodic_bspline_2d(
        jnp.asarray(coeffs), jnp.asarray(pts_x + eps), jnp.asarray(pts_y))
    vm, _, _ = eval_periodic_bspline_2d(
        jnp.asarray(coeffs), jnp.asarray(pts_x - eps), jnp.asarray(pts_y))
    np.testing.assert_allclose(np.asarray(dx), (vp - vm) / (2 * eps), atol=1e-5)


def test_clamped_interp_matches_scipy(rng):
    n = 11
    data = rng.normal(size=n)
    coeffs = fit_clamped_interp_bspline(data)
    ref = CubicSpline(np.arange(n), data, bc_type='clamped')  # zero-slope ends
    x = rng.uniform(0, n - 1.0, 40)
    v, d = eval_clamped_interp(jnp.asarray(coeffs), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(v), ref(x), atol=1e-9)
    np.testing.assert_allclose(np.asarray(d), ref.derivative()(x), atol=1e-8)
    # outside the domain: constant continuation
    v_lo, d_lo = eval_clamped_interp(jnp.asarray(coeffs), jnp.asarray(-3.0))
    v_hi, d_hi = eval_clamped_interp(jnp.asarray(coeffs), jnp.asarray(n + 2.0))
    assert abs(float(v_lo) - data[0]) < 1e-9 and float(d_lo) == 0.0
    assert abs(float(v_hi) - data[-1]) < 1e-9 and float(d_hi) == 0.0


def test_layered_batch_eval(rng):
    coeffs = rng.normal(size=(3, 9))
    layer = np.array([0, 2, 1, 0])
    x = rng.uniform(1.0, 6.9, size=4)
    v, _ = eval_clamped_bspline(jnp.asarray(coeffs)[layer], jnp.asarray(x))
    for i in range(4):
        vi, _ = eval_clamped_bspline(jnp.asarray(coeffs[layer[i]]),
                                     jnp.asarray(x[i]))
        assert abs(float(v[i]) - float(vi)) < 1e-12
