"""Two-view relative pose estimation + epipolar-rematch refinement.

Host-level orchestration around the jitted RANSAC/recovery kernels,
mirroring `ViewGraph::findRelativePose` (src/ViewGraph.cpp:600-650) and
`ViewGraph::refinePose` (:725-783): alternate (re)matching gated by the
current fundamental matrix with re-estimation, keeping the pose while the
cheirality-inlier count grows (max 10 rounds).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from irotavg_tpu import so3
from irotavg_tpu.geometry.essential import ransac_essential, recover_pose
from irotavg_tpu.matching.matchers import matches_to_pairs


@dataclasses.dataclass
class RelativePose:
    """Result of a two-view solve: x2 ~ R x1 + t (camera-1 to camera-2)."""

    R: np.ndarray            # (3, 3)
    t: np.ndarray            # (3,)
    E: np.ndarray            # (3, 3) essential matrix (normalised coords)
    n_cheirality: int        # inliers passing depth test
    inlier_mask: np.ndarray  # (M,) over the input pairs

    @property
    def q(self) -> np.ndarray:
        """Relative rotation as [x y z w] (edge convention R_j = R_ij R_i)."""
        return np.asarray(so3.rotmat_to_quat(self.R))


def _bucket(n, lo=64):
    b = lo
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass(frozen=True)
class _TwoViewSolver:
    n_samples: int = 1024

    def __call__(self, p1, p2, valid, seed, th_norm):
        key = jax.random.key(jnp.asarray(seed, jnp.uint32))
        E, inl, _ = ransac_essential(
            p1, p2, valid, key, th_norm=th_norm, n_samples=self.n_samples
        )
        R, t, n_che, pose_mask = recover_pose(E, p1, p2, inl)
        return E, R, t, n_che, pose_mask


_solver = _TwoViewSolver()
_solve_jit = jax.jit(_solver.__call__)


@functools.partial(jax.jit, static_argnames=("has_nodes", "max_iters"))
def _refine_seeded(bits1, nodes1, valid1, angle1, x1, y1, oct1,
                   bits2t, nodes2, valid2, angle2, x2, y2,
                   E0, R0, t0, n0, m12_0, K_inv, sigma2, cam, th_norm,
                   seed, min_pairs, *, has_nodes, max_iters):
    """`fused_refine` behind a seed scalar (key created in-program) with
    optional ``None`` node arrays — one dispatch from pure-numpy hosts."""
    from irotavg_tpu.geometry.fused import fused_refine

    key = jax.random.key(jnp.asarray(seed, jnp.uint32))
    if not has_nodes:
        nodes1 = jnp.zeros(x1.shape, jnp.int32)
        nodes2 = jnp.zeros(x2.shape, jnp.int32)
    return fused_refine(
        bits1, nodes1, valid1, angle1, x1, y1, oct1,
        bits2t, nodes2, valid2, angle2, x2, y2,
        E0, R0, t0, n0, m12_0, K_inv, sigma2, cam, th_norm, key,
        min_pairs, has_nodes=has_nodes, max_iters=max_iters,
    )


def find_relative_pose(f1, f2, pairs, camera, *, th: float = 1.0,
                       seed: int = 0) -> RelativePose | None:
    """Estimate the relative pose from matched feature pairs.

    ``pairs``: (M, 2) indices into f1/f2 features (undistorted coords are
    used, like the reference).  Returns None when M <= 4 (reference
    asserts) or RANSAC support is too small (<= 6 inliers, reference
    check at src/ViewGraph.cpp:637).
    """
    m = len(pairs)
    if m <= 4:
        return None
    # normalised coords (undistorted pixels -> K^-1)
    x1 = (f1.xu[pairs[:, 0]] - camera.cx) / camera.fx
    y1 = (f1.yu[pairs[:, 0]] - camera.cy) / camera.fy
    x2 = (f2.xu[pairs[:, 1]] - camera.cx) / camera.fx
    y2 = (f2.yu[pairs[:, 1]] - camera.cy) / camera.fy

    mp = _bucket(m)
    p1 = np.zeros((mp, 2), np.float32)
    p2 = np.zeros((mp, 2), np.float32)
    p1[:m, 0], p1[:m, 1] = x1, y1
    p2[:m, 0], p2[:m, 1] = x2, y2
    valid = np.zeros(mp, bool)
    valid[:m] = True

    th_norm = th / float(camera.fx)
    # numpy straight to the jit call: transfers ride the one dispatch
    res = _solve_jit(p1, p2, valid, np.uint32(seed & 0xFFFFFFFF),
                     np.float32(th_norm))
    E, R, t, n_che, pose_mask = jax.device_get(res)  # one bundled fetch
    n_che = int(n_che)
    if n_che <= 6:
        return None
    return RelativePose(
        R=np.asarray(R, np.float64),
        t=np.asarray(t, np.float64),
        E=np.asarray(E, np.float64),
        n_cheirality=n_che,
        inlier_mask=pose_mask[:m],
    )


def refine_pose(f1, f2, rel: RelativePose, pairs, camera, *,
                min_matches: int = 100, max_iters: int = 10,
                seed: int = 1) -> tuple[RelativePose, np.ndarray]:
    """Alternate epipolar-guided rematching and re-estimation
    (`ViewGraph::refinePose`).  ``pairs`` is the current (already
    inlier-filtered) match set for ``rel``.  Returns (best_pose,
    inlier_pairs).

    The whole alternation runs as ONE device program
    (geometry/fused.py:fused_refine) — the reference's host loop would
    cost ~20 dispatches and fetches here.  Host inputs go to the jit call
    as numpy (transfers ride the dispatch; explicit per-array
    ``jnp.asarray``/``jax.random.key`` would each be their own
    dispatch)."""
    from irotavg_tpu.matching.matchers import _bits, _dev

    K_inv = np.linalg.inv(camera.K).astype(np.float32)
    n1 = f1.capacity if hasattr(f1, "capacity") else len(f1.valid)
    m12_0 = np.full(n1, -1, np.int32)
    m12_0[pairs[:, 0]] = pairs[:, 1]
    n_oct = 8
    sigma2 = ((1.2 ** np.arange(n_oct)) ** 2).astype(np.float32)
    cam = np.asarray(
        [camera.fx, camera.fy, camera.cx, camera.cy], np.float32
    )
    has_nodes = f1.feat_nodes is not None and f2.feat_nodes is not None
    res = _refine_seeded(
        _bits(f1),
        _dev(f1, "feat_nodes") if has_nodes else None,
        _dev(f1, "valid"), _dev(f1, "angle"),
        _dev(f1, "xu"), _dev(f1, "yu"), _dev(f1, "octave"),
        _bits(f2).T,
        _dev(f2, "feat_nodes") if has_nodes else None,
        _dev(f2, "valid"), _dev(f2, "angle"),
        _dev(f2, "xu"), _dev(f2, "yu"),
        np.asarray(rel.E, np.float32), np.asarray(rel.R, np.float32),
        np.asarray(rel.t, np.float32), np.int32(len(pairs)), m12_0,
        K_inv, sigma2, cam,
        np.float32(1.0 / camera.fx), np.uint32(seed & 0xFFFFFFFF),
        np.int32(int(np.ceil(0.75 * min_matches))),
        has_nodes=has_nodes, max_iters=max_iters,
    )
    E, R, t, n, m12, _ = jax.device_get(res)  # one bundled fetch
    n = int(n)
    if n > len(pairs):
        best_pairs = matches_to_pairs(m12)
        best = RelativePose(
            R=np.asarray(R, np.float64), t=np.asarray(t, np.float64),
            E=np.asarray(E, np.float64), n_cheirality=n,
            inlier_mask=np.ones(len(best_pairs), bool),
        )
        return best, best_pairs
    return rel, pairs
