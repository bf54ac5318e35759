"""Steered BRIEF-256 descriptors from gathered patches.

Parity with computeOrbDescriptor (src/ORBExtractor.cpp:133-172): for each
keypoint with angle theta (a=cos, b=sin), each pattern point (px, py) is
sampled at integer offsets ``x = round(px*a - py*b)``, ``y = round(px*b +
py*a)`` from the *blurred* level image, and bit j is ``I(p_{2j}) <
I(p_{2j+1})``.  Bits are packed little-endian within bytes (bit k of byte
i compares points 16i+2k, 16i+2k+1), stored here as 8 uint32 words per
descriptor — word w holds bytes 4w..4w+3, byte b at bit offset 8*(b%4).

The array re-design samples all 512 rotated pattern points of all keypoints
with one gather from per-keypoint patches: rotated offsets never exceed
round(max pattern radius) <= 18 px, so a (K, 41, 41) patch gather (radius
20) covers every rotation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from irotavg_tpu.ops.orb_pattern import ORB_PATTERN

PATCH_R = 20  # patch radius covering all rotated pattern offsets (<= 18)
PATCH_W = 2 * PATCH_R + 1


def _pattern_points() -> np.ndarray:
    """(512, 2) pattern points in (x, y) order: row j gives points 2j, 2j+1."""
    return ORB_PATTERN.reshape(512, 2)


@functools.partial(jax.jit, inline=True)
def steered_brief(patches, angles):
    """Descriptors for (K, 41, 41) blurred patches and (K,) angles (rad).

    Returns (K, 8) uint32 — 256 bits per keypoint.
    """
    pts = jnp.asarray(_pattern_points(), jnp.float32)  # (512, 2) [x, y]
    a = jnp.cos(angles)[:, None]  # (K, 1)
    b = jnp.sin(angles)[:, None]
    px = pts[None, :, 0]  # (1, 512)
    py = pts[None, :, 1]
    # reference: x = round(px*a - py*b), y = round(px*b + py*a)
    xo = jnp.round(px * a - py * b).astype(jnp.int32) + PATCH_R
    yo = jnp.round(px * b + py * a).astype(jnp.int32) + PATCH_R

    flat = patches.reshape(patches.shape[0], -1)  # (K, 41*41)
    idx = yo * PATCH_W + xo  # (K, 512)
    vals = jnp.take_along_axis(flat, idx, axis=1)  # (K, 512)

    t0 = vals[:, 0::2]
    t1 = vals[:, 1::2]
    bits = (t0 < t1).astype(jnp.uint32)  # (K, 256)

    bits = bits.reshape(bits.shape[0], 8, 32)  # word-major, bit j -> word j//32
    shifts = jnp.arange(32, dtype=jnp.uint32)
    words = jnp.sum(bits << shifts[None, None, :], axis=2, dtype=jnp.uint32)
    return words
