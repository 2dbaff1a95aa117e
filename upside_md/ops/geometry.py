"""Vector geometry for coarse-grained protein MD, batched elementwise.

All functions are pure jnp and differentiate with jax.grad — the reference's
hand-written derivative "germs" (e.g. the Blondel–Karplus dihedral
derivative, src/vector_math.h:703-735, and the eigenvector perturbation
theory in src/eig.cpp:388-470) are replaced by autodiff through the same
forward math.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def mag(v, axis=-1, keepdims=False):
    return jnp.sqrt(jnp.sum(v * v, axis=axis, keepdims=keepdims))


def mag2(v, axis=-1, keepdims=False):
    return jnp.sum(v * v, axis=axis, keepdims=keepdims)


def normalized(v, axis=-1, eps=0.0):
    return v / (mag(v, axis=axis, keepdims=True) + eps)


def dihedral(r1, r2, r3, r4):
    """Dihedral angle in (-pi, pi] for points shaped (..., 3).

    Same sign convention as the reference dihedral_germ
    (src/vector_math.h:703-735): atan2(dot(C,G), dot(A,B)*|G|) with
    F=r1-r2, G=r2-r3, H=r4-r3, A=FxG, B=HxG, C=BxA.
    """
    F = r1 - r2
    G = r2 - r3
    H = r4 - r3
    A = jnp.cross(F, G)
    B = jnp.cross(H, G)
    C = jnp.cross(B, A)
    Gmag = mag(G)
    return jnp.arctan2(jnp.sum(C * G, -1), jnp.sum(A * B, -1) * Gmag)


def wrap_angle(x):
    """Map an angle difference into (-pi, pi] via a single-period shift."""
    x = jnp.where(x > jnp.pi, x - 2.0 * jnp.pi, x)
    x = jnp.where(x < -jnp.pi, x + 2.0 * jnp.pi, x)
    return x


def quat_to_rot(q):
    """Unit quaternion (..., 4) [a,b,c,d] -> rotation matrix (..., 3, 3).

    Same element layout as reference quat_to_rot (src/affine.h:98-108).
    """
    a, b, c, d = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = jnp.stack([
        a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c),
        2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b),
        2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d,
    ], axis=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_rot(angle, axis):
    """Axis (unit, (...,3)) + angle (...) -> rotation matrix (..., 3, 3).

    Matches reference axis_angle_to_rot (src/affine.h:49-64).
    """
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    C = 1.0 - c
    r = jnp.stack([
        x * x * C + c, x * y * C - z * s, x * z * C + y * s,
        y * x * C + z * s, y * y * C + c, y * z * C - x * s,
        z * x * C - y * s, z * y * C + x * s, z * z * C + c,
    ], axis=-1)
    return r.reshape(angle.shape + (3, 3))


def max_eigvec_sym4(F, n_newton=25):
    """Largest eigenvalue/eigenvector of a batched symmetric traceless 4x4.

    Batched replacement for the reference's Householder+implicit-QR
    (src/eig.cpp:232-273) and for jnp.linalg.eigh: Newton iteration on the
    characteristic quartic from an upper bound (monotone convergence to the
    largest root), then the eigenvector from the Cayley–Hamilton adjugate
    of (F - lambda I).  Everything is batched matmuls/polynomials — no
    per-element factorization — and differentiates cleanly (at convergence
    the Newton fixed point gives the implicit-function gradient; the
    reference's eigenvector perturbation theory comes out of autodiff).

    Assumes the largest eigenvalue is simple, as the reference does for
    alignment to a nearly rigid structure (eig.cpp:428-429).
    """
    # 4x4 products as broadcast multiply-reduce, NOT dot_general: batched
    # tiny matmuls are far too small for a matrix unit, the elementwise
    # form fuses with its neighbours, and it stays in full f32 (an f32
    # dot at default precision may run in TF32 on the GPU)
    def mm4(A, B):
        return jnp.sum(A[..., :, :, None] * B[..., None, :, :], axis=-2)

    F2 = mm4(F, F)
    F3 = mm4(F2, F)
    p2 = jnp.trace(F2, axis1=-2, axis2=-1)
    p3 = jnp.trace(F3, axis1=-2, axis2=-1)
    p4 = jnp.sum(F2 * jnp.swapaxes(F2, -1, -2), axis=(-1, -2))
    # char poly of traceless F: l^4 + c2 l^2 + c1 l + c0  (Newton identities)
    c2 = -0.5 * p2
    c1 = -p3 / 3.0
    c0 = 0.25 * (0.5 * p2 * p2 - p4)

    lam = jnp.sqrt(jnp.maximum(p2, 1e-20))  # upper bound: lmax^2 <= tr(F^2)

    # unrolled Newton (a lax.scan of tiny iterations serializes poorly)
    for _ in range(n_newton):
        P = ((lam * lam + c2) * lam + c1) * lam + c0
        dP = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        lam = lam - P / jnp.where(jnp.abs(dP) > 1e-20, dP, 1e-20)

    # adjugate of B = F - lam I via Cayley–Hamilton:
    #   adj(B) = -(B^3 + b3 B^2 + b2 B + b1 I), b-coeffs from traces of B^k
    eye = jnp.eye(4, dtype=F.dtype)
    B = F - lam[..., None, None] * eye
    B2 = mm4(B, B)
    B3 = mm4(B2, B)
    t1 = jnp.trace(B, axis1=-2, axis2=-1)
    t2 = jnp.trace(B2, axis1=-2, axis2=-1)
    t3 = jnp.trace(B3, axis1=-2, axis2=-1)
    b3 = -t1
    b2 = 0.5 * (t1 * t1 - t2)
    b1 = -(t1 ** 3 - 3.0 * t1 * t2 + 2.0 * t3) / 6.0
    adj = -(B3 + b3[..., None, None] * B2 + b2[..., None, None] * B
            + b1[..., None, None] * eye)

    # any nonzero column of adj(B) spans the eigenvector; pick the largest
    # (one-hot contraction, not take_along_axis: it stays inside the
    # elementwise fusion)
    norms2 = jnp.sum(adj * adj, axis=-2)            # (..., 4) column norms
    best = jnp.argmax(norms2, axis=-1)
    onehot = (jnp.arange(4) == best[..., None]).astype(adj.dtype)
    col = jnp.sum(adj * onehot[..., None, :], axis=-1)
    v = col / jnp.sqrt(jnp.maximum(jnp.sum(col * col, -1, keepdims=True), 1e-30))
    return lam, v


def rigid_alignment(atoms, ref_geom):
    """Optimal-rotation rigid alignment per group (Coutsias quaternion RMSD).

    atoms:    (..., 3, 3) current positions of the 3 backbone atoms (N,CA,C)
    ref_geom: (..., 3, 3) reference geometry (already centered)
    Returns (translation (..., 3), quaternion (..., 4)) where quaternion
    rotates ref_geom onto the centered atoms (largest-eigenvalue eigenvector
    of the 4x4 quaternion matrix; reference src/eig.cpp:277-386).  The
    quaternion sign is arbitrary, as in the reference — all consumers are
    sign-invariant (quat_to_rot).
    """
    center = jnp.mean(atoms, axis=-2)
    x = atoms - center[..., None, :]
    # R[i,j] = sum_a x_a[j] * ref_a[i]  (broadcast multiply-reduce over the
    # 3-atom axis, not a batched tiny dot_general -- see max_eigvec_sym4)
    R = jnp.sum(ref_geom[..., :, :, None] * x[..., :, None, :], axis=-3)
    R00, R01, R02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    R10, R11, R12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    R20, R21, R22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    F = jnp.stack([
        jnp.stack([R00 + R11 + R22, R12 - R21, R20 - R02, R01 - R10], -1),
        jnp.stack([R12 - R21, R00 - R11 - R22, R01 + R10, R02 + R20], -1),
        jnp.stack([R20 - R02, R01 + R10, -R00 + R11 - R22, R12 + R21], -1),
        jnp.stack([R01 - R10, R02 + R20, R12 + R21, -R00 - R11 + R22], -1),
    ], axis=-2)

    _, quat = max_eigvec_sym4(F)
    return center, quat


def rotate_vec(R, v):
    """Batched 3x3 matrix-vector product as a broadcast multiply-reduce
    (batched tiny dot_generals are too small for a matrix unit and may
    run in TF32 on the GPU; the elementwise form fuses and stays f32)."""
    return jnp.sum(R * v[..., None, :], axis=-1)


def apply_affine(t, q, v):
    """Rotate local coordinates v (..., 3) by quaternion q and translate."""
    return rotate_vec(quat_to_rot(q), v) + t


def apply_rotation(q, v):
    return rotate_vec(quat_to_rot(q), v)
