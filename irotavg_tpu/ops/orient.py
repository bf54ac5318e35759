"""Intensity-centroid keypoint orientation (IC_Angle).

Parity with src/ORBExtractor.cpp:102-129 and the umax circle construction
in the ctor (src/ORBExtractor.cpp:481-495): moments m10 = sum u*I and
m01 = sum v*I over the radius-15 discretised disc, angle = atan2(m01, m10).
(The reference uses cv::fastAtan2, a <=0.3 deg approximation; we use exact
atan2 — divergence is far below descriptor-bit sensitivity.)

The array re-design computes moments for all keypoints at once from gathered
(31, 31) patches — three masked reductions instead of a
per-keypoint scalar loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

HALF_PATCH = 15


def _umax() -> np.ndarray:
    """The reference's symmetric quarter-circle column bounds."""
    umax = np.zeros(HALF_PATCH + 2, np.int64)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: HALF_PATCH + 1]


@functools.lru_cache(maxsize=1)
def orb_disc_mask() -> np.ndarray:
    """(31, 31) bool — the exact pixel disc IC_Angle sums over."""
    um = _umax()
    mask = np.zeros((31, 31), bool)
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        d = um[abs(v)]
        mask[v + HALF_PATCH, HALF_PATCH - d : HALF_PATCH + d + 1] = True
    return mask


@functools.partial(jax.jit, inline=True)
def ic_angles(patches):
    """Angles (radians, in [0, 2pi)) for (K, 31, 31) float patches centred
    on the keypoints (unblurred pyramid level)."""
    mask = jnp.asarray(orb_disc_mask(), jnp.float32)
    uu = jnp.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=jnp.float32)
    vv = uu  # same range for rows
    wu = mask * uu[None, :]
    wv = mask * vv[:, None]
    m10 = jnp.sum(patches * wu[None], axis=(1, 2))
    m01 = jnp.sum(patches * wv[None], axis=(1, 2))
    ang = jnp.arctan2(m01, m10)
    return jnp.where(ang < 0, ang + 2 * jnp.pi, ang)
