"""Gather-free dense window-weight splines match the gathered evaluation."""

import numpy as np
import jax
import jax.numpy as jnp

from upside_md.ops.spline import (bspline_window_weights, eval_bspline,
                                      eval_bspline_dense,
                                      eval_clamped_bspline)


def test_dense_matches_gathered_unclamped(rng):
    c = rng.normal(size=15)
    x = rng.uniform(1.0, 12.9, size=40)
    v_ref, _ = eval_bspline(jnp.asarray(c), jnp.asarray(x))
    v = eval_bspline_dense(jnp.asarray(c), jnp.asarray(x), clamped=False)
    np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref), atol=1e-12)


def test_dense_matches_gathered_clamped(rng):
    c = rng.normal(size=16)
    x = rng.uniform(-2.0, 18.0, size=60)  # includes out-of-range
    v_ref, d_ref = eval_clamped_bspline(jnp.asarray(c), jnp.asarray(x))
    v = eval_bspline_dense(jnp.asarray(c), jnp.asarray(x), clamped=True)
    np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref), atol=1e-12)

    # derivative also matches (and is zero in the clamped regions)
    g_ref = np.asarray(jax.grad(
        lambda xx: jnp.sum(eval_clamped_bspline(jnp.asarray(c), xx)[0]))(
            jnp.asarray(x)))
    g = np.asarray(jax.grad(
        lambda xx: jnp.sum(eval_bspline_dense(jnp.asarray(c), xx)))(
            jnp.asarray(x)))
    np.testing.assert_allclose(g, g_ref, atol=1e-10)


def test_window_weights_partition(rng):
    W = bspline_window_weights(jnp.asarray(rng.uniform(1, 6.9, 20)), 9, True)
    np.testing.assert_allclose(np.asarray(W).sum(-1), 1.0, atol=1e-12)
    assert (np.count_nonzero(np.asarray(W), axis=-1) <= 4).all()
