"""Image primitives: reflect padding, separable Gaussian blur, bilinear
resize, pyramid size chain.

Contracts follow the reference front-end (src/ORBExtractor.cpp:1132-1157):
8-level pyramid with scale 1.2, each level resized from the *previous*
level (chained INTER_LINEAR), BORDER_REFLECT_101 padding, and the 7x7
sigma=2 Gaussian blur applied before descriptor sampling
(src/ORBExtractor.cpp:1111).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def pyramid_sizes(h: int, w: int, n_levels: int, scale: float):
    """Per-level (h, w), each computed like the reference: round(orig *
    scale^-level) (src/ORBExtractor.cpp:1135-1136 uses the cumulative
    inverse factor of the original size)."""
    sizes = []
    for lv in range(n_levels):
        s = 1.0 / (scale ** lv)
        sizes.append((int(round(h * s)), int(round(w * s))))
    return sizes


def pad_reflect101(img, pad: int):
    """BORDER_REFLECT_101 (``dcb|abcd|cba``) padding on both spatial axes."""
    return jnp.pad(img, ((pad, pad), (pad, pad)), mode="reflect")


def _gauss_kernel(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV getGaussianKernel: exp(-x^2/(2 sigma^2)), normalised."""
    r = (ksize - 1) / 2.0
    x = np.arange(ksize) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _band_matrix(n: int, kernel_bytes: bytes) -> np.ndarray:
    """(n, n) banded matrix B with REFLECT_101 boundaries folded in, such
    that ``img @ B`` applies the 1-D kernel along the last axis."""
    k = np.frombuffer(kernel_bytes, np.float32)
    ksize = len(k)
    pad = ksize // 2
    B = np.zeros((n, n), np.float32)
    for i in range(n):
        for o in range(ksize):
            j = i + o - pad
            if j < 0:                       # dcb|abcd
                j = -j
            elif j >= n:                    # abcd|cba
                j = 2 * n - 2 - j
            B[j, i] += k[o]
    return B


def _sep_blur(img, k: np.ndarray):
    """Separable blur as two banded-matrix matmuls.

    A 7-diagonal band matrix per axis turns each pass into one dense
    matmul (~0.4 GFLOP/frame at 640x480) in place of 7 shifted slices
    per pass, with the REFLECT_101 boundary folded into the matrix.  HIGHEST precision keeps f32 accuracy so the rounded
    blurred image matches the reference's uint8 blur bit-for-bit
    (modulo ties) for descriptor parity (src/ORBExtractor.cpp:1111).
    """
    h, w = img.shape
    Bw = jnp.asarray(_band_matrix(w, k.tobytes()))
    Bh = jnp.asarray(_band_matrix(h, k.tobytes()))
    row = jnp.matmul(img, Bw, precision=jax.lax.Precision.HIGHEST)
    return jnp.matmul(Bh.T, row, precision=jax.lax.Precision.HIGHEST)


def gaussian_blur7(img, sigma: float = 2.0):
    """7x7 separable Gaussian blur, BORDER_REFLECT_101 — the descriptor
    pre-blur (src/ORBExtractor.cpp:1111).  float32 in/out."""
    return _sep_blur(img, _gauss_kernel(7, sigma))


def resize_bilinear(img, out_h: int, out_w: int):
    """Bilinear resize with half-pixel alignment (cv::resize INTER_LINEAR
    convention: src = (dst + 0.5) * scale - 0.5, edge-clamped)."""
    h, w = img.shape
    sy = h / out_h
    sx = w / out_w
    yy = (jnp.arange(out_h, dtype=jnp.float32) + 0.5) * sy - 0.5
    xx = (jnp.arange(out_w, dtype=jnp.float32) + 0.5) * sx - 0.5
    y0 = jnp.clip(jnp.floor(yy), 0, h - 1)
    x0 = jnp.clip(jnp.floor(xx), 0, w - 1)
    wy = jnp.clip(yy - y0, 0.0, 1.0)
    wx = jnp.clip(xx - x0, 0.0, 1.0)
    y0 = y0.astype(jnp.int32)
    x0 = x0.astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, h - 1)
    x1 = jnp.minimum(x0 + 1, w - 1)

    r0 = img[y0, :]
    r1 = img[y1, :]
    row = r0 * (1.0 - wy)[:, None] + r1 * wy[:, None]
    c0 = row[:, x0]
    c1 = row[:, x1]
    return c0 * (1.0 - wx)[None, :] + c1 * wx[None, :]
