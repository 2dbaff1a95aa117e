import numpy as np
import jax
import jax.numpy as jnp

from upside_md.ops.geometry import (
    dihedral, quat_to_rot, axis_angle_to_rot, rigid_alignment, wrap_angle)


def reference_dihedral(p0, p1, p2, p3):
    """Independent textbook dihedral (atan2 of projections)."""
    b0 = p0 - p1
    b1 = p2 - p1
    b2 = p3 - p2
    b1 /= np.linalg.norm(b1)
    v = b0 - np.dot(b0, b1) * b1
    w = b2 - np.dot(b2, b1) * b1
    x = np.dot(v, w)
    y = np.dot(np.cross(b1, v), w)
    return np.arctan2(y, x)


def test_dihedral_matches_textbook(rng):
    # note: this JAX build evaluates transcendentals (arctan2 on arrays)
    # with float32-level accuracy even under x64, hence the 1e-6 tolerance
    for _ in range(20):
        p = rng.normal(size=(4, 3))
        d = float(dihedral(*[jnp.asarray(x) for x in p]))
        assert abs(wrap_angle(d - reference_dihedral(*p))) < 1e-6


def test_dihedral_batched(rng):
    p = rng.normal(size=(7, 4, 3))
    d = dihedral(jnp.asarray(p[:, 0]), jnp.asarray(p[:, 1]),
                 jnp.asarray(p[:, 2]), jnp.asarray(p[:, 3]))
    for i in range(7):
        assert abs(float(d[i]) - reference_dihedral(*p[i])) < 1e-6


def test_quat_to_rot_orthogonal(rng):
    q = rng.normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = np.asarray(quat_to_rot(jnp.asarray(q)))
    for i in range(5):
        np.testing.assert_allclose(R[i] @ R[i].T, np.eye(3), atol=1e-12)
        assert abs(np.linalg.det(R[i]) - 1.0) < 1e-12


def test_axis_angle(rng):
    axis = np.array([0.0, 0.0, 1.0])
    R = np.asarray(axis_angle_to_rot(jnp.asarray(np.pi / 2), jnp.asarray(axis)))
    np.testing.assert_allclose(R @ np.array([1.0, 0, 0]), [0, 1, 0], atol=1e-12)


def test_rigid_alignment_recovers_rotation(rng):
    # reference geometry: centered N/CA/C triangle
    ref = rng.normal(size=(3, 3))
    ref -= ref.mean(0)
    q0 = rng.normal(size=4)
    q0 /= np.linalg.norm(q0)
    R0 = np.asarray(quat_to_rot(jnp.asarray(q0)))
    t0 = rng.normal(size=3)
    atoms = ref @ R0.T + t0

    center, quat = rigid_alignment(jnp.asarray(atoms)[None], jnp.asarray(ref)[None])
    np.testing.assert_allclose(np.asarray(center[0]), t0, atol=1e-8)
    R = np.asarray(quat_to_rot(quat))[0]
    np.testing.assert_allclose(R, R0, atol=1e-5)


def test_rigid_alignment_gradient_finite(rng):
    ref = rng.normal(size=(4, 3, 3))
    ref -= ref.mean(1, keepdims=True)
    atoms = ref + 0.1 * rng.normal(size=(4, 3, 3)) + rng.normal(size=(4, 1, 3))

    def f(a):
        c, q = rigid_alignment(a, jnp.asarray(ref))
        return jnp.sum(c * c) + jnp.sum(q[:, 1] ** 2)

    g = jax.grad(f)(jnp.asarray(atoms))
    assert np.all(np.isfinite(np.asarray(g)))
