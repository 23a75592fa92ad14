"""Vectorized geometry primitives.

Vectorized rewrites of the reference's scalar Eigen helpers:
  - normal angle / normal & coplanarity predicates  (FCCF.cpp:369-407, C7)
  - Rodrigues rotations and the closed-form two-step rotation construction
    used in hypothesis generation and rotation averaging
    (FCCF.cpp:841-904, :1148-1196, C13/C15)
  - quaternion <-> matrix conversions and rotation of vectors
    (Eigen::Quaternionf usage throughout the reference)

All functions broadcast over leading batch dims and are NaN-safe under
masking: callers are expected to mask outputs where inputs are invalid.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def normalize(v, eps=_EPS):
    """Unit vector along last axis; zero vectors map to zero (not NaN)."""
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.maximum(n, eps)


def angle_deg(n1, n2):
    """Angle in degrees between (possibly non-unit) vectors.

    Mirrors ``compute_normal_angel`` (FCCF.cpp:369-377): cos via normalized
    dot, acos, degrees. Clipped to [-1, 1] for numerical safety (the
    reference relies on fp behavior of acos of ~1+eps returning NaN; we
    clip, which only affects exactly-parallel vectors).
    """
    num = jnp.sum(n1 * n2, axis=-1)
    den = jnp.linalg.norm(n1, axis=-1) * jnp.linalg.norm(n2, axis=-1)
    cos = jnp.clip(num / jnp.maximum(den, _EPS), -1.0, 1.0)
    return jnp.degrees(jnp.arccos(cos))


def same_normal(n1, n2, thresh_deg):
    """``compare_normal`` (FCCF.cpp:379-389): angle <= threshold."""
    return angle_deg(n1, n2) <= thresh_deg


def coplanar(n1, c1, n2, c2, l, k):
    """``compare_plane`` (FCCF.cpp:391-407).

    Distance-adaptive coplanarity: with d = unit(c1 - c2),
    both |n1.d| and |n2.d| must be < l / (k*|c1-c2| + 1).
    NOTE: the reference does NOT normalize n1/n2 here (only d), and feeds
    non-unit averaged face normals — we replicate that exactly.
    """
    d = c1 - c2
    dist = jnp.linalg.norm(d, axis=-1)
    dhat = d / jnp.maximum(dist, _EPS)[..., None]
    t = l / (k * dist + 1.0)
    ok = (jnp.abs(jnp.sum(n1 * dhat, axis=-1)) < t) & (
        jnp.abs(jnp.sum(n2 * dhat, axis=-1)) < t
    )
    # Coincident centroids (dist ~ 0): direction undefined; the reference
    # would divide by zero. Treat as coplanar (same voxel center).
    return jnp.where(dist > _EPS, ok, True)


def skew(v):
    """Cross-product matrix [v]_x, batched over leading dims."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def rodrigues(axis, cos_t, sin_t):
    """R = cos*I + (1-cos)*rr^T + sin*[r]_x with r = axis (unit)."""
    eye = jnp.broadcast_to(jnp.eye(3, dtype=axis.dtype), axis.shape[:-1] + (3, 3))
    rrt = axis[..., :, None] * axis[..., None, :]
    return (
        cos_t[..., None, None] * eye
        + (1.0 - cos_t)[..., None, None] * rrt
        + sin_t[..., None, None] * skew(axis)
    )


def rotation_between_planes(n1, m1, n2, m2):
    """Closed-form R = R2 @ R1 aligning plane pair (n2, m2) -> (n1, m1).

    Faithful port of ``computer_transform``'s rotation block
    (FCCF.cpp:848-895): R1 is a Rodrigues rotation taking n2 to n1 (axis
    n2 x n1); R2 rotates about n1 to take R1@m2 onto m1. Inputs may be
    non-unit (the reference feeds unnormalized averaged face normals and
    uses raw dot products for cos/sin; we replicate that).

    Returns (R, m2_rot) where m2_rot = R1 @ m2 (the reference reuses this
    rotated m2 for the plane-offset solve, a quirk we must preserve).
    """
    r1 = normalize(jnp.cross(n2, n1))
    cos1 = jnp.sum(n2 * n1, axis=-1)
    sin1 = jnp.sum(jnp.cross(r1, n2) * n1, axis=-1)
    R1 = rodrigues(r1, cos1, sin1)
    m2r = jnp.einsum("...ij,...j->...i", R1, m2)

    r2 = n1  # NOTE: unnormalized in the reference too (FCCF.cpp:873)
    m2dm1 = jnp.sum(m2r * m1, axis=-1)
    m2dr2 = jnp.sum(m2r * r2, axis=-1)
    m1dr2 = jnp.sum(m1 * r2, axis=-1)
    denom = 1.0 - m2dr2 * m1dr2
    denom = jnp.where(jnp.abs(denom) > _EPS, denom, _EPS)
    cos2 = (m2dm1 - m2dr2 * m1dr2) / denom
    sin2 = jnp.sum(jnp.cross(r2, m2r) * m1, axis=-1) / denom
    R2 = rodrigues(r2, cos2, sin2)
    return R2 @ R1, m2r


def rotation_from_two_axes(nt1, nt2):
    """Reconstruct R with R@x_hat ~ nt1 and R@y_hat ~ nt2.

    The rotation-averaging reconstruction used by ``transform_cluster``
    (FCCF.cpp:1148-1196) and ``fuse_answer`` (FCCF.cpp:1306-1354): two
    Rodrigues steps mapping the canonical frame (x_hat, y_hat) onto the
    averaged rotated axes. nt1/nt2 should be unit (averaged then
    normalized upstream).
    """
    ns1 = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], nt1.dtype), nt1.shape)
    ns2 = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], nt1.dtype), nt1.shape)
    r1 = normalize(jnp.cross(ns1, nt1))
    cos1 = jnp.sum(nt1 * ns1, axis=-1)
    sin1 = jnp.sum(nt1 * jnp.cross(r1, ns1), axis=-1)
    R1 = rodrigues(r1, cos1, sin1)
    ns2r = jnp.einsum("...ij,...j->...i", R1, ns2)
    r2 = nt1
    ns2dnt2 = jnp.sum(ns2r * nt2, axis=-1)
    ns2dr2 = jnp.sum(ns2r * r2, axis=-1)
    nt2dr2 = jnp.sum(nt2 * r2, axis=-1)
    denom = 1.0 - ns2dr2 * nt2dr2
    denom = jnp.where(jnp.abs(denom) > _EPS, denom, _EPS)
    cos2 = (ns2dnt2 - ns2dr2 * nt2dr2) / denom
    sin2 = jnp.sum(jnp.cross(r2, ns2r) * nt2, axis=-1) / denom
    R2 = rodrigues(r2, cos2, sin2)
    return R2 @ R1


# --------------------------------------------------------------------------
# Quaternions. Convention: (w, x, y, z), matching Eigen's storage-agnostic
# accessor use in the reference (qw, qx, qy, qz fields of transform_q_t).
# --------------------------------------------------------------------------


def quat_rotate(q, v):
    """Rotate vector(s) v by unit quaternion(s) q = (w, x, y, z)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_multiply(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = 2.0 / jnp.maximum(n, _EPS)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return jnp.stack(
        [
            jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=-1),
            jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=-1),
            jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def matrix_to_quat(R):
    """Rotation matrix -> unit quaternion (w, x, y, z).

    Branch-free Shepperd-style: computes all four candidate forms and
    selects the best-conditioned one. Sign convention is irrelevant to the
    pipeline (quaternions are only ever used to rotate vectors or averaged
    through rotated-axis sums, both sign-invariant).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4, 4)
    mags = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    best = jnp.argmax(mags, axis=-1)
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, -1), axis=-2)[
        ..., 0, :
    ]
    return normalize(q)


def make_transform(R, t):
    """Assemble a 4x4 homogeneous transform from R (3,3) and t (3,)."""
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (4, 4), R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def apply_transform(T, pts):
    """Apply 4x4 transform to points (..., N, 3)."""
    return pts @ T[..., :3, :3].mT + T[..., :3, 3][..., None, :]


def rotation_error_deg(R_est, R_gt):
    """Relative rotation error (degrees).

    tr(R_gt^T R_est) is computed as the elementwise dot sum(R_gt * R_est)
    — NOT a matmul — so the metric is exact f32 even in eager mode on a
    backend whose default matmul precision is reduced (TF32 or bf16: a
    trace error of ~3e-3 fabricates ~4 deg of rotation error near
    identity)."""
    tr = jnp.sum(R_gt * R_est, axis=(-2, -1))
    cos = jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return jnp.degrees(jnp.arccos(cos))


def translation_error(t_est, t_gt):
    return jnp.linalg.norm(t_est - t_gt, axis=-1)
