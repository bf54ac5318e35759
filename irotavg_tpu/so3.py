"""Batched SO(3) / quaternion kernels.

Conventions follow the reference solver (ral/l1_irls.hpp:43-51): quaternions
are stored row-wise as ``[x, y, z, w]`` in ``(n, 4)`` arrays, Hamilton product,
rotation composition ``R(qmul(a, b)) = R(a) @ R(b)``.

Everything here is shape-polymorphic over leading batch axes and safe under
``jit``/``vmap``/``grad`` (divide-by-zero guarded with ``where``, not
NaN-scrubbing).  The kernels are **namespace-polymorphic**: fed numpy
arrays they compute in numpy and return numpy — every op-by-op ``jnp``
call from host bookkeeping code is its own device dispatch, so host-side
quaternion math (the engine's edge/warm-start plumbing) never touches the
device.  Fed jax arrays
(or called under jit) they compute in ``jnp`` exactly as before.

Reference parity notes:
  * ``qinv_flipw`` reproduces the reference's inverse-by-negating-w quirk
    (ral/l1_irls.cpp:115-116, 959-960): negating w yields ``-conj(q)``, which
    represents the same rotation (double cover) — downstream ``log_map``
    wraps the angle so results agree.
  * ``exp_map``/``log_map`` match ral/l1_irls.cpp:471-532 including the
    theta wrap to [-pi, pi) and the zero-angle guards.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Machine-epsilon guard used by the reference (ral/l1_irls.hpp:39).
EPS = 2.2204e-16


def _ns(*xs):
    """numpy unless any input is a jax array/tracer (see module doc)."""
    return jnp if any(isinstance(x, jax.Array) for x in xs) else np

__all__ = [
    "EPS",
    "qmul",
    "qconj",
    "qinv_flipw",
    "qnormalize",
    "qidentity",
    "exp_map",
    "log_map",
    "delta_rel",
    "quat_to_rotmat",
    "rotmat_to_quat",
    "qangle",
    "qgeodesic",
    "random_quat",
]


def qidentity(shape=(), dtype=jnp.float32):
    """Identity quaternion(s) ``[0, 0, 0, 1]`` with leading ``shape``."""
    q = jnp.zeros(tuple(shape) + (4,), dtype=dtype)
    return q.at[..., 3].set(1.0)


def qmul(q1, q2):
    """Hamilton product of ``[x y z w]`` quaternions; broadcasts leading axes.

    Matches ``quat_mult`` (ral/l1_irls.cpp:99-105): composition order is
    ``R(qmul(q1, q2)) = R(q1) @ R(q2)``.
    """
    xp = _ns(q1, q2)
    x1, y1, z1, w1 = xp.moveaxis(q1, -1, 0)
    x2, y2, z2, w2 = xp.moveaxis(q2, -1, 0)
    return xp.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=-1,
    )


def qconj(q):
    """Proper conjugate ``[-x, -y, -z, w]``."""
    xp = _ns(q)
    return q * xp.asarray([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def qinv_flipw(q):
    """Reference-style 'inverse': negate w only (= ``-conj(q)``).

    Same rotation as the true inverse by the double cover; used where the
    reference negates col 3 (ral/l1_irls.cpp:115-116).
    """
    xp = _ns(q)
    return q * xp.asarray([1.0, 1.0, 1.0, -1.0], dtype=q.dtype)


def qnormalize(q, eps=0.0):
    """Normalise quaternion rows to unit norm."""
    xp = _ns(q)
    n = xp.linalg.norm(q, axis=-1, keepdims=True)
    return q / xp.maximum(n, xp.asarray(max(eps, 1e-300), dtype=q.dtype))


def exp_map(v):
    """Batched SO(3) exponential: rows ``[v1 v2 v3]`` (or ``[v1 v2 v3 *]``) ->
    unit quaternions ``[v*sin(t/2)/t, cos(t/2)]`` with ``t = |v|``.

    Zero-angle rows map to identity (the reference gets there by scrubbing
    NaNs, ral/l1_irls.cpp:471-492; we use a guarded ``where``).
    """
    xp = _ns(v)
    v = v[..., :3]
    theta = xp.linalg.norm(v, axis=-1, keepdims=True)
    half = 0.5 * theta
    safe_theta = xp.where(theta > 0, theta, 1.0)
    coef = xp.where(theta > 0, xp.sin(half) / safe_theta, 0.0)
    return xp.concatenate([v * coef, xp.cos(half)], axis=-1)


def log_map(q):
    """Batched SO(3) log: quaternion rows -> ``[r*theta, theta]`` rows where
    ``theta`` is wrapped to [-pi, pi).

    Matches ral/l1_irls.cpp:498-532: ``theta = 2*atan2(|xyz|, w)`` then wrap;
    rows with ``|xyz| < EPS`` produce a zero tangent vector.
    """
    xp = _ns(q)
    xyz = q[..., :3]
    w = q[..., 3]
    s2 = xp.linalg.norm(xyz, axis=-1)
    theta = 2.0 * xp.arctan2(s2, w)
    theta = xp.where(theta < -xp.pi, theta + 2.0 * xp.pi, theta)
    theta = xp.where(theta >= xp.pi, theta - 2.0 * xp.pi, theta)
    safe_s2 = xp.where(s2 < EPS, 1.0, s2)
    scale = xp.where(s2 < EPS, 0.0, theta / safe_s2)
    return xp.concatenate(
        [xyz * scale[..., None], theta[..., None]], axis=-1
    )


def delta_rel(edges, QQ, Q):
    """Per-edge loop residual ``qinv(Q[j]) * QQ[k] * Q[i]`` for all edges.

    Matches ``delta_rel`` (ral/l1_irls.cpp:109-127) but fully batched:
    ``edges`` is ``(m, 2)`` int array of ``(i, j)`` node indices, ``QQ`` is
    ``(m, 4)`` relative rotations, ``Q`` is ``(n, 4)`` absolute rotations.
    """
    qi = Q[edges[:, 0]]
    qj_inv = qinv_flipw(Q[edges[:, 1]])
    return qmul(qj_inv, qmul(QQ, qi))


def quat_to_rotmat(q):
    """Unit quaternion rows ``[x y z w]`` -> rotation matrices ``(..., 3, 3)``
    with the convention ``R(qmul(a,b)) = R(a) @ R(b)``."""
    xp = _ns(q)
    x, y, z, w = xp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = xp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def rotmat_to_quat(R):
    """Rotation matrices ``(..., 3, 3)`` -> unit quaternion rows ``[x y z w]``.

    Branchless Shepperd-style selection of the most stable of the four
    candidate formulas (behavioural parity with ``rmat2quat``,
    src/ViewGraph.cpp:1175-1203), vectorised over leading axes.
    """
    xp = _ns(R)
    m00 = R[..., 0, 0]
    m11 = R[..., 1, 1]
    m22 = R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate (w, x, y, z) tuples, each scaled by its 4*q_k.
    def cand_w():
        s = xp.sqrt(xp.maximum(1.0 + tr, 0.0)) * 2.0  # s = 4w
        w = 0.25 * s
        x = (R[..., 2, 1] - R[..., 1, 2]) / xp.where(s > 0, s, 1.0)
        y = (R[..., 0, 2] - R[..., 2, 0]) / xp.where(s > 0, s, 1.0)
        z = (R[..., 1, 0] - R[..., 0, 1]) / xp.where(s > 0, s, 1.0)
        return xp.stack([x, y, z, w], axis=-1)

    def cand_x():
        s = xp.sqrt(xp.maximum(1.0 + m00 - m11 - m22, 0.0)) * 2.0  # 4x
        x = 0.25 * s
        d = xp.where(s > 0, s, 1.0)
        w = (R[..., 2, 1] - R[..., 1, 2]) / d
        y = (R[..., 0, 1] + R[..., 1, 0]) / d
        z = (R[..., 0, 2] + R[..., 2, 0]) / d
        return xp.stack([x, y, z, w], axis=-1)

    def cand_y():
        s = xp.sqrt(xp.maximum(1.0 - m00 + m11 - m22, 0.0)) * 2.0  # 4y
        y = 0.25 * s
        d = xp.where(s > 0, s, 1.0)
        w = (R[..., 0, 2] - R[..., 2, 0]) / d
        x = (R[..., 0, 1] + R[..., 1, 0]) / d
        z = (R[..., 1, 2] + R[..., 2, 1]) / d
        return xp.stack([x, y, z, w], axis=-1)

    def cand_z():
        s = xp.sqrt(xp.maximum(1.0 - m00 - m11 + m22, 0.0)) * 2.0  # 4z
        z = 0.25 * s
        d = xp.where(s > 0, s, 1.0)
        w = (R[..., 1, 0] - R[..., 0, 1]) / d
        x = (R[..., 0, 2] + R[..., 2, 0]) / d
        y = (R[..., 1, 2] + R[..., 2, 1]) / d
        return xp.stack([x, y, z, w], axis=-1)

    qw, qx, qy, qz = cand_w(), cand_x(), cand_y(), cand_z()
    # Pick by largest of (tr, m00, m11, m22), mirroring the classic branch.
    use_w = (tr > 0)[..., None]
    use_x = ((m00 >= m11) & (m00 >= m22))[..., None]
    use_y = (m11 >= m22)[..., None]
    q = xp.where(use_w, qw, xp.where(use_x, qx, xp.where(use_y, qy, qz)))
    return qnormalize(q)


def qangle(q):
    """Rotation angle in radians of quaternion rows, in [0, pi]."""
    xp = _ns(q)
    xyz = xp.linalg.norm(q[..., :3], axis=-1)
    w = xp.abs(q[..., 3])
    return 2.0 * xp.arctan2(xyz, w)


def qgeodesic(q1, q2):
    """Geodesic angle between two unit quaternions (radians, [0, pi])."""
    return qangle(qmul(qconj(q1), q2))


def random_quat(key, shape=(), dtype=jnp.float32):
    """Uniformly distributed random unit quaternions (Shoemake subgroup alg.)."""
    u = jax.random.uniform(key, tuple(shape) + (3,), dtype=dtype)
    u1, u2, u3 = u[..., 0], u[..., 1], u[..., 2]
    a = jnp.sqrt(1.0 - u1)
    b = jnp.sqrt(u1)
    t2 = 2.0 * jnp.pi * u2
    t3 = 2.0 * jnp.pi * u3
    return jnp.stack(
        [a * jnp.sin(t2), a * jnp.cos(t2), b * jnp.sin(t3), b * jnp.cos(t3)],
        axis=-1,
    )
