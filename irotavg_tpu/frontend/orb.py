"""ORB feature extraction — the whole pyramid as one compiled XLA program.

Functional parity with the reference extractor (src/ORBExtractor.cpp):

* 8-level chained-bilinear pyramid, scale 1.2 (`ComputePyramid`, :1132-1157);
* geometric per-level feature budgets (ctor, :461-472);
* FAST-9/16 with high/low threshold fallback per cell (:833-842) — here as
  dense score maps + blocked reductions (ops/fast.py);
* spatial balancing — the quadtree (`DistributeOctTree`, :564-788) keeps the
  max-response keypoint per adaptively split cell; here: per-16px-cell
  argmax then global top-K by response, which preserves the same contract
  (spatial spread + response ranking) with static shapes;
* intensity-centroid orientation on the unblurred level (:497-530);
* 7x7 sigma=2 Gaussian blur then steered BRIEF-256 (:1111, :133-172);
* keypoint coords scaled back to level-0 pixels (:1121-1127).

Everything is padded/masked: each level yields exactly ``budget[level]``
slots with a validity mask, so one executable serves every frame of a
sequence.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from irotavg_tpu.ops.image import gaussian_blur7, pyramid_sizes, resize_bilinear
from irotavg_tpu.ops.fast import cell_fallback_mask, fast_score_map, nms3
from irotavg_tpu.ops.orient import ic_angles
from irotavg_tpu.ops.brief import PATCH_R, PATCH_W, steered_brief

DET_BORDER = 19  # detection border: EDGE_THRESHOLD-3 cell origin + 3 FAST margin
SEL_CELL = 16    # spatial-balance cell (px)
TH_CELL = 32     # two-threshold fallback cell (px)


@dataclasses.dataclass(frozen=True)
class OrbParams:
    """Extractor settings (the five ORB-SLAM YAML keys, src/IRotAvg.cpp:82-89)."""

    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7

    def level_budgets(self) -> list[int]:
        """Geometric distribution over levels (ctor, src/ORBExtractor.cpp:461-472)."""
        factor = 1.0 / self.scale_factor
        ndesired = (
            self.n_features * (1 - factor)
            / (1 - factor ** self.n_levels)
        )
        budgets, acc = [], 0
        for _ in range(self.n_levels - 1):
            budgets.append(int(round(ndesired)))
            acc += budgets[-1]
            ndesired *= factor
        budgets.append(max(self.n_features - acc, 0))
        return budgets

    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.n_levels)


def _extract_level(img, th_hi, th_lo, k_budget: int):
    """All keypoints of one pyramid level.  Static: image shape, k_budget."""
    h, w = img.shape
    score = fast_score_map(img)

    # valid detection region (3-px FAST margin inside the 16-px border)
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    region = (
        (yy >= DET_BORDER) & (yy < h - DET_BORDER)
        & (xx >= DET_BORDER) & (xx < w - DET_BORDER)
    )
    score = jnp.where(region, score, -jnp.inf)

    # two-threshold fallback per cell + NMS
    hpad = -h % TH_CELL
    wpad = -w % TH_CELL
    sp = jnp.pad(score, ((0, hpad), (0, wpad)), constant_values=-jnp.inf)
    corners = cell_fallback_mask(sp, th_hi, th_lo, TH_CELL)[:h, :w]
    corners &= nms3(score)
    cscore = jnp.where(corners, score, -jnp.inf)

    # spatial balance: per-SEL_CELL argmax, then global top-K
    hc = -(-h // SEL_CELL)
    wc = -(-w // SEL_CELL)
    cs = jnp.pad(
        cscore,
        ((0, hc * SEL_CELL - h), (0, wc * SEL_CELL - w)),
        constant_values=-jnp.inf,
    )
    blocks = cs.reshape(hc, SEL_CELL, wc, SEL_CELL).transpose(0, 2, 1, 3)
    blocks = blocks.reshape(hc * wc, SEL_CELL * SEL_CELL)
    in_cell = jnp.argmax(blocks, axis=1)
    cell_max = jnp.take_along_axis(blocks, in_cell[:, None], axis=1)[:, 0]

    k = min(k_budget, hc * wc)
    top_val, top_cell = jax.lax.top_k(cell_max, k)
    valid = jnp.isfinite(top_val)
    off = in_cell[top_cell]
    cy = (top_cell // wc) * SEL_CELL + off // SEL_CELL
    cx = (top_cell % wc) * SEL_CELL + off % SEL_CELL
    cy = jnp.clip(cy, 0, h - 1)
    cx = jnp.clip(cx, 0, w - 1)

    # orientation from unblurred patches
    pad = PATCH_R
    ip = jnp.pad(img, pad, mode="reflect")

    def patch(src, y, x, r):
        return jax.lax.dynamic_slice(
            src, (y - r + pad, x - r + pad), (2 * r + 1, 2 * r + 1)
        )

    patches31 = jax.vmap(lambda y, x: patch(ip, y, x, 15))(cy, cx)
    angles = ic_angles(patches31)

    # descriptors from blurred patches
    bp = jnp.pad(gaussian_blur7(img), pad, mode="reflect")
    # quantise like the reference's uint8 blurred image
    bp = jnp.round(bp)
    patches41 = jax.vmap(lambda y, x: patch(bp, y, x, PATCH_R))(cy, cx)
    desc = steered_brief(patches41, angles)

    return {
        "x": cx.astype(jnp.float32),
        "y": cy.astype(jnp.float32),
        "response": top_val,
        "angle": angles,
        "desc": desc,
        "valid": valid,
    }


@lru_cache(maxsize=8)
def _compiled_extractor(h: int, w: int, params: OrbParams):
    sizes = pyramid_sizes(h, w, params.n_levels, params.scale_factor)
    budgets = params.level_budgets()
    scales = params.scale_factors()

    @jax.jit
    def extract(img, th_hi, th_lo):
        levels = []
        cur = img.astype(jnp.float32)   # cast on device: uint8 uploads are
        if cur.ndim == 3:               # 4x fewer bytes than f32
            cur = (0.299 * cur[..., 0] + 0.587 * cur[..., 1]
                   + 0.114 * cur[..., 2])
        for lv in range(params.n_levels):
            if lv > 0:
                cur = resize_bilinear(cur, *sizes[lv])
            out = _extract_level(cur, th_hi, th_lo, budgets[lv])
            s = jnp.float32(scales[lv])
            out["x0"] = out["x"] * s  # level-0 pixel coords
            out["y0"] = out["y"] * s
            out["octave"] = jnp.full(out["x"].shape, lv, jnp.int32)
            out["size"] = jnp.full(out["x"].shape, 31.0 * scales[lv], jnp.float32)
            levels.append(out)
        return {
            key: jnp.concatenate([l[key] for l in levels])
            for key in levels[0]
        }

    return extract


class ORBExtractor:
    """Drop-in functional equivalent of the reference `ORBextractor`.

    Call with a (H, W) uint8/float grayscale image; returns a dict of
    fixed-capacity arrays (total = sum of level budgets):
    ``x0, y0`` level-0 pixel coords, ``x, y`` level coords, ``octave``,
    ``size``, ``angle`` (radians), ``response``, ``desc`` (N, 8) uint32,
    ``valid`` mask.
    """

    def __init__(self, n_features=2000, scale_factor=1.2, n_levels=8,
                 ini_th_fast=20, min_th_fast=7):
        self.params = OrbParams(
            n_features=n_features,
            scale_factor=scale_factor,
            n_levels=n_levels,
            ini_th_fast=ini_th_fast,
            min_th_fast=min_th_fast,
        )

    @property
    def capacity(self) -> int:
        """Upper bound on output slots (tiny top levels may clamp below
        their nominal budget when they have fewer selection cells)."""
        return sum(self.params.level_budgets())

    def __call__(self, image) -> dict:
        # the image goes to the jitted program as-is (numpy, native dtype):
        # the upload rides the dispatch, the f32 cast and any RGB->gray
        # (ITU-R BT.601, like cv::cvtColor) run on device.  Host-side
        # `jnp.asarray`/`jnp.float32` here would each be their own
        # dispatch.
        img = np.asarray(image)
        h, w = img.shape[:2]
        fn = _compiled_extractor(h, w, self.params)
        return fn(img, np.float32(self.params.ini_th_fast),
                  np.float32(self.params.min_th_fast))
