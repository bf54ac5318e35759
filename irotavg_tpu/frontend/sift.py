"""SIFT feature extraction — the reference's alternative front-end.

The reference gates `Frame::findFeatures` on a compile-time `USE_ORB` flag;
with it off, features come from `cv::xfeatures2d::SIFT::detectAndCompute`
(src/Frame.cpp:64-99), and the (dead) `findSIFTMatches` matcher consumes
the float descriptors (src/ViewGraph.cpp:694-722).  This module provides
the same capability as one compiled XLA program per image size:

* Gaussian scale space: per octave, ``s+3`` separable blurs; DoG stack as
  slice differences — all dense convolutions (dense array friendly).
* Keypoints: 26-neighbour extrema of the DoG stack, contrast threshold,
  2x2-Hessian edge rejection — dense masks, then per-octave top-K by |DoG|
  so every frame yields the same static shapes (pad + `valid` mask).
* Orientation: 36-bin Gaussian-weighted gradient histogram around the
  keypoint, peak bin with parabolic refinement.
* Descriptor: the standard 4x4 spatial x 8 orientation-bin layout (128-d,
  L2-normalised, 0.2-clamped, renormalised), computed by bilinear-sampling
  the octave gradient fields on a rotated 16x16 grid — one `vmap` over
  keypoints instead of OpenCV's per-keypoint loop.

Unlike the ORB path, SIFT descriptors are float vectors, so BoW place
recognition (trained on ORB bits) does not apply — identical to the
reference, where the vocabulary is only meaningful with USE_ORB=1.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from irotavg_tpu.ops.image import pad_reflect101


@dataclasses.dataclass(frozen=True)
class SiftParams:
    """cv::xfeatures2d::SIFT::create() defaults (the reference passes
    no arguments at src/Frame.cpp:97)."""

    n_features: int = 2000          # capacity (OpenCV default 0 = unlimited)
    n_octave_layers: int = 3        # s
    contrast_threshold: float = 0.04
    edge_threshold: float = 10.0
    sigma: float = 1.6


def _gauss1d(sigma: float) -> np.ndarray:
    r = max(int(np.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img, k1d: np.ndarray):
    r = (len(k1d) - 1) // 2
    k = jnp.asarray(k1d)
    p = pad_reflect101(img, r)
    out = jax.lax.conv_general_dilated(
        p[None, None], k[None, None, None, :], (1, 1), "VALID"
    )[0, 0]
    out = jax.lax.conv_general_dilated(
        out[:, None, None, :].transpose(2, 1, 3, 0),
        k[None, None, None, :], (1, 1), "VALID",
    )
    return out[0, 0].T


def _scale_space(img, params: SiftParams, n_octaves: int):
    """Per octave: gaussians (s+3, H, W), grads, dogs (s+2, H, W)."""
    s = params.n_octave_layers
    k = 2.0 ** (1.0 / s)
    # incremental blur amounts between successive scales
    sig_prev = params.sigma
    inc = []
    for i in range(1, s + 3):
        sig_total = params.sigma * k ** i
        inc.append(float(np.sqrt(sig_total ** 2 - sig_prev ** 2)))
        sig_prev = sig_total
    octaves = []
    base = _blur(img, _gauss1d(params.sigma))  # assume sigma_in ~ 0
    for _ in range(n_octaves):
        gauss = [base]
        for i in range(s + 2):
            gauss.append(_blur(gauss[-1], _gauss1d(inc[i])))
        g = jnp.stack(gauss)                     # (s+3, H, W)
        dog = g[1:] - g[:-1]                     # (s+2, H, W)
        octaves.append((g, dog))
        nxt = gauss[s]                           # 2x sigma image
        base = nxt[::2, ::2]
        if base.shape[0] < 16 or base.shape[1] < 16:
            break
    return octaves


def _extrema_mask(dog, contrast_th: float, edge_th: float):
    """(s, H, W) bool for the middle DoG slices: 26-neighbour extremum,
    contrast and edge tests."""
    d = dog  # (s+2, H, W)
    mid = d[1:-1]
    # neighbour stack: 27 shifted copies over (scale, y, x)
    neigh_max = jnp.full_like(mid, -jnp.inf)
    neigh_min = jnp.full_like(mid, jnp.inf)
    for ds in (-1, 0, 1):
        sl = d[1 + ds: d.shape[0] - 1 + ds]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                sh = jnp.roll(sl, (dy, dx), axis=(1, 2))
                neigh_max = jnp.maximum(neigh_max, sh)
                neigh_min = jnp.minimum(neigh_min, sh)
    is_ext = (mid > neigh_max) | (mid < neigh_min)
    is_ext &= jnp.abs(mid) > contrast_th / 2.0  # OpenCV pre-threshold

    # edge rejection: 2x2 spatial Hessian trace²/det < (r+1)²/r
    dxx = (jnp.roll(mid, -1, 2) + jnp.roll(mid, 1, 2) - 2 * mid)
    dyy = (jnp.roll(mid, -1, 1) + jnp.roll(mid, 1, 1) - 2 * mid)
    dxy = (
        jnp.roll(mid, (-1, -1), (1, 2)) + jnp.roll(mid, (1, 1), (1, 2))
        - jnp.roll(mid, (-1, 1), (1, 2)) - jnp.roll(mid, (1, -1), (1, 2))
    ) * 0.25
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_th
    is_ext &= (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)

    # keep off the border
    h, w = mid.shape[1:]
    yy = jnp.arange(h)[None, :, None]
    xx = jnp.arange(w)[None, None, :]
    b = 8
    is_ext &= (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b)
    return is_ext


def _bilinear(field, y, x):
    """Sample (H, W) field at float (y, x) with clamping."""
    h, w = field.shape
    y = jnp.clip(y, 0.0, h - 1.001)
    x = jnp.clip(x, 0.0, w - 1.001)
    y0 = jnp.floor(y).astype(jnp.int32)
    x0 = jnp.floor(x).astype(jnp.int32)
    fy = y - y0
    fx = x - x0
    v00 = field[y0, x0]
    v01 = field[y0, x0 + 1]
    v10 = field[y0 + 1, x0]
    v11 = field[y0 + 1, x0 + 1]
    return ((1 - fy) * (1 - fx) * v00 + (1 - fy) * fx * v01
            + fy * (1 - fx) * v10 + fy * fx * v11)


def _orientation(gx, gy, y, x, sigma):
    """36-bin Gaussian-weighted gradient histogram peak (radians)."""
    r = 8
    dy, dx = jnp.mgrid[-r:r + 1, -r:r + 1].astype(jnp.float32)
    sy = y + dy.ravel()
    sx = x + dx.ravel()
    vx = _bilinear(gx, sy, sx)
    vy = _bilinear(gy, sy, sx)
    mag = jnp.sqrt(vx * vx + vy * vy)
    wgt = jnp.exp(-(dy.ravel() ** 2 + dx.ravel() ** 2)
                  / (2.0 * (1.5 * sigma) ** 2))
    ang = jnp.arctan2(vy, vx)                       # [-pi, pi)
    bins = jnp.floor((ang + jnp.pi) / (2 * jnp.pi) * 36).astype(jnp.int32)
    bins = jnp.clip(bins, 0, 35)
    hist = jnp.zeros((36,)).at[bins].add(mag * wgt)
    # circular smoothing then peak with parabolic interpolation
    hist = (jnp.roll(hist, 1) + hist + jnp.roll(hist, -1)) / 3.0
    p = jnp.argmax(hist)
    l_ = hist[(p - 1) % 36]
    c = hist[p]
    rr = hist[(p + 1) % 36]
    denom = l_ - 2 * c + rr
    off = jnp.where(jnp.abs(denom) > 1e-12,
                    0.5 * (l_ - rr) / denom, 0.0)
    theta = (p + off + 0.5) / 36.0 * 2 * jnp.pi - jnp.pi
    return theta


def _descriptor(gx, gy, y, x, sigma, theta):
    """128-d SIFT descriptor: 16x16 rotated samples -> 4x4x8 bins."""
    d, nbins = 4, 8
    width = 3.0 * sigma                     # histogram cell width (px)
    ii, jj = jnp.mgrid[0:16, 0:16].astype(jnp.float32)
    u = (ii.ravel() - 7.5) / 4.0            # cell units, [-1.875, 1.875]
    v = (jj.ravel() - 7.5) / 4.0
    ct, st = jnp.cos(theta), jnp.sin(theta)
    sy = y + width * (u * ct + v * st)
    sx = x + width * (-u * st + v * ct)
    vx = _bilinear(gx, sy, sx)
    vy = _bilinear(gy, sy, sx)
    mag = jnp.sqrt(vx * vx + vy * vy)
    wgt = jnp.exp(-(u * u + v * v) / (2 * (0.5 * d) ** 2))
    ang = jnp.arctan2(vy, vx) - theta
    obin = jnp.floor((ang % (2 * jnp.pi)) / (2 * jnp.pi) * nbins)
    obin = jnp.clip(obin.astype(jnp.int32), 0, nbins - 1)
    sb_i = jnp.clip(jnp.floor(ii.ravel() / 4).astype(jnp.int32), 0, d - 1)
    sb_j = jnp.clip(jnp.floor(jj.ravel() / 4).astype(jnp.int32), 0, d - 1)
    flat = (sb_i * d + sb_j) * nbins + obin
    desc = jnp.zeros((d * d * nbins,)).at[flat].add(mag * wgt)
    nrm = jnp.linalg.norm(desc) + 1e-12
    desc = jnp.clip(desc / nrm, 0.0, 0.2)
    return desc / (jnp.linalg.norm(desc) + 1e-12)


def _extract_octave(g, dog, params: SiftParams, budget: int):
    """Top-``budget`` keypoints of one octave (octave-local coords)."""
    s = params.n_octave_layers
    mask = _extrema_mask(dog, params.contrast_threshold,
                         params.edge_threshold)      # (s, H, W)
    score = jnp.where(mask, jnp.abs(dog[1:-1]), -jnp.inf)
    flat = score.reshape(-1)
    h, w = score.shape[1:]
    top_val, top_idx = jax.lax.top_k(flat, budget)
    valid = jnp.isfinite(top_val)
    li = top_idx // (h * w)                  # DoG layer 0..s-1
    yy = (top_idx % (h * w)) // w
    xx = top_idx % w
    yf = yy.astype(jnp.float32)
    xf = xx.astype(jnp.float32)

    k = 2.0 ** (1.0 / s)
    sig_layer = params.sigma * k ** (li.astype(jnp.float32) + 1.0)

    # gradient fields per gaussian layer (layers 1..s used)
    gxs = (jnp.roll(g, -1, 2) - jnp.roll(g, 1, 2)) * 0.5
    gys = (jnp.roll(g, -1, 1) - jnp.roll(g, 1, 1)) * 0.5

    def per_kp(layer, y, x, sig):
        gx = gxs[layer + 1]
        gy = gys[layer + 1]
        th = _orientation(gx, gy, y, x, sig)
        de = _descriptor(gx, gy, y, x, sig, th)
        return th, de

    theta, desc = jax.vmap(per_kp)(li, yf, xf, sig_layer)
    resp = jnp.where(valid, top_val, 0.0)
    return {
        "x": xf, "y": yf, "layer": li, "sigma": sig_layer,
        "angle": theta, "response": resp, "desc": desc, "valid": valid,
    }


@lru_cache(maxsize=8)
def _compiled_sift(h: int, w: int, params: SiftParams, n_octaves: int):
    budgets = _octave_budgets(params.n_features, n_octaves)

    @jax.jit
    def extract(img):
        octaves = _scale_space(img, params, n_octaves)
        outs = []
        for o, (g, dog) in enumerate(octaves):
            out = _extract_octave(g, dog, params, budgets[o])
            sc = jnp.float32(2.0 ** o)
            out["x0"] = out["x"] * sc
            out["y0"] = out["y"] * sc
            out["octave"] = jnp.full(out["x"].shape, o, jnp.int32)
            out["size"] = out["sigma"] * sc * 2.0
            del out["layer"], out["sigma"]
            outs.append(out)
        return {k_: jnp.concatenate([o[k_] for o in outs])
                for k_ in outs[0]}

    return extract


def _octave_budgets(n_features: int, n_octaves: int) -> list[int]:
    """Geometric split (most features live in the finest octave)."""
    raw = [n_features * 0.5 ** o for o in range(n_octaves)]
    tot = sum(raw)
    b = [max(int(round(n_features * r / tot)), 8) for r in raw]
    b[0] += n_features - sum(b)
    return b


class SIFTExtractor:
    """Functional counterpart of cv::xfeatures2d::SIFT (src/Frame.cpp:97).

    Returns the same dict layout as :class:`ORBExtractor` — ``x0, y0,
    octave, size, angle, response, valid`` — with ``desc`` as (N, 128)
    float32 rows instead of packed 256-bit words.
    """

    def __init__(self, n_features: int = 2000, n_octave_layers: int = 3,
                 contrast_threshold: float = 0.04,
                 edge_threshold: float = 10.0, sigma: float = 1.6,
                 n_octaves: int = 4):
        self.params = SiftParams(
            n_features=n_features, n_octave_layers=n_octave_layers,
            contrast_threshold=contrast_threshold,
            edge_threshold=edge_threshold, sigma=sigma,
        )
        self.n_octaves = n_octaves

    @property
    def capacity(self) -> int:
        return sum(_octave_budgets(self.params.n_features, self.n_octaves))

    def __call__(self, image) -> dict:
        img = jnp.asarray(np.asarray(image), jnp.float32)
        if img.ndim == 3:
            img = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                   + 0.114 * img[..., 2])
        img = img / 255.0
        h, w = img.shape
        n_oct = min(self.n_octaves,
                    max(int(np.log2(min(h, w) / 16.0)), 1))
        fn = _compiled_sift(h, w, self.params, n_oct)
        return fn(img)
