"""FAST-9/16 corner detection as dense score maps.

Re-design of the per-cell OpenCV FAST calls in the reference
(src/ORBExtractor.cpp:790-878): instead of looping 30x30-px cells, compute
the corner *score map* for the whole level at once — 16 shifted
copies of the image, bright/dark arc tests via windowed minima — then apply
3x3 non-max suppression and the per-cell two-threshold fallback as blocked
reductions.

Score definition matches OpenCV's FAST-9 corner score (the largest
threshold at which the pixel is still detected): for the bright test,
``max over the 16 contiguous 9-arcs of (min over arc of I(x_i) - I(p))``;
dark symmetric; final score = max(bright, dark) - 1.  A pixel is a corner
at threshold t iff score >= t  (equivalently the strict arc test passes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3, in circular order (OpenCV's pixel ring).
# (dy, dx) starting at 12 o'clock, clockwise.
FAST_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
        (-3, -1),
    ],
    dtype=np.int32,
)

ARC = 9  # contiguous arc length for FAST-9


@functools.partial(jax.jit, inline=True)
def fast_score_map(img):
    """FAST-9/16 corner score for every pixel.

    Args:
      img: (H, W) float32 (integral pixel values).
    Returns:
      (H, W) float32 score map; pixels within 3 px of the border get -inf.
      A pixel is a corner at threshold t iff score >= t.
    """
    h, w = img.shape
    pad = 3
    p = jnp.pad(img, pad, mode="edge")

    # d[k] = ring neighbour k minus center
    diffs = [
        jax.lax.dynamic_slice(p, (pad + dy, pad + dx), (h, w)) - img
        for dy, dx in FAST_OFFSETS
    ]
    d = jnp.stack(diffs, axis=0)  # (16, H, W)

    # windowed min over each contiguous 9-arc (circular): extend to 24
    ext = jnp.concatenate([d, d[: ARC - 1]], axis=0)  # (24, H, W)
    # bright: min over window of d ; dark: min over window of -d
    def arc_scores(vals):
        # vals (24, H, W) -> per-start min over 9 -> max over 16 starts
        mins = vals[:16]
        for k in range(1, ARC):
            mins = jnp.minimum(mins, ext_roll(vals, k))
        return jnp.max(mins, axis=0)

    def ext_roll(vals, k):
        return jax.lax.dynamic_slice_in_dim(vals, k, 16, axis=0)

    bright = arc_scores(ext)
    dark = arc_scores(-ext)
    score = jnp.maximum(bright, dark) - 1.0

    # invalidate the 3-px frame (no full ring context)
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    interior = (yy >= pad) & (yy < h - pad) & (xx >= pad) & (xx < w - pad)
    return jnp.where(interior, score, -jnp.inf)


@functools.partial(jax.jit, inline=True)
def nms3(score):
    """3x3 non-max suppression: keep pixels that are the strict maximum of
    their neighbourhood (ties broken toward the top-left, like OpenCV's
    row-scan which requires > for previously seen neighbours)."""
    h, w = score.shape
    p = jnp.pad(score, 1, mode="constant", constant_values=-jnp.inf)
    keep = jnp.ones_like(score, dtype=bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = jax.lax.dynamic_slice(p, (1 + dy, 1 + dx), (h, w))
            if (dy, dx) < (0, 0) or (dy == 0 and dx < 0):
                keep &= score > nb  # earlier in scan order: must beat
            else:
                keep &= score >= nb
    return keep


def cell_fallback_mask(score, th_hi: float, th_lo: float, cell: int = 32):
    """Two-threshold detection with per-cell fallback.

    Parity with src/ORBExtractor.cpp:833-842: cells that contain at least
    one high-threshold corner use the high threshold; cells with none fall
    back to the low threshold.  ``cell`` is static; the map is evaluated
    per cell block via reshaped reductions (H, W must be divisible — pad
    the score map with -inf first if needed).
    """
    h, w = score.shape
    assert h % cell == 0 and w % cell == 0, "pad score map to cell multiple"
    hi = score >= th_hi
    blocks = hi.reshape(h // cell, cell, w // cell, cell)
    cell_has_hi = blocks.any(axis=(1, 3))
    cell_has_hi = jnp.repeat(jnp.repeat(cell_has_hi, cell, 0), cell, 1)
    lo = score >= th_lo
    return jnp.where(cell_has_hi, hi, lo)
