"""Quantified front-end divergences vs the reference's algorithms.

The front-end intentionally diverges from the reference in two
places (both noted in SURVEY.md section 7 "hard parts"); these tests put
asserted numbers on each divergence instead of leaving it anecdotal:

(a) Keypoint selection.  The reference balances keypoints with a
    recursive quadtree, keeping the max-response corner per final cell
    (`DistributeOctTree`, src/ORBExtractor.cpp:564-788).  Ours keeps the
    max-response corner per fixed grid cell.  Same spirit (spatial
    uniformity + response ranking), different partition — so we measure
    spatial coverage and warp repeatability against cv2.ORB (the
    reference extractor's family) and bound the gap.

(b) Two-view RANSAC.  The reference calls cv::findEssentialMat — an
    adaptive-iteration 5-point solver (src/ViewGraph.cpp:600-650); ours
    is a fixed-budget batched 8-point with cheirality re-ranking
    (irotavg_tpu/geometry/essential.py:387).  A fixed S-sample budget
    has success probability 1-(1-eps^8)^S at inlier ratio eps, so it
    *must* break below some eps while the adaptive 5-point keeps going.
    The sweep pins the break point and asserts it sits below the SLAM
    operating band (the matchers feeding RANSAC are ratio-, rotation-
    histogram- and epipolar-gated, so real match sets run ~70-95%
    inliers; see the gating in src/ViewGraph.cpp:125-569).
"""

import cv2
import numpy as np
import pytest

import jax

from seqgen import make_sequence
from irotavg_tpu import so3
from irotavg_tpu.frontend.orb import ORBExtractor


# ---------------------------------------------------------------------------
# (a) keypoint distribution / repeatability vs cv2.ORB
# ---------------------------------------------------------------------------

N_FEATURES = 1000
GRID = (16, 12)           # 40x40 px coverage cells on 640x480
REPEAT_TOL_PX = 3.0


@pytest.fixture(scope="module")
def textured_frame():
    frames, _, _ = make_sequence(n_frames=1, seed=7)
    return frames[0]


def _our_kps(img):
    ext = ORBExtractor(n_features=N_FEATURES, n_levels=8)
    out = ext(img)
    v = np.asarray(out["valid"])
    return np.stack([np.asarray(out["x0"])[v], np.asarray(out["y0"])[v]], 1)


def _cv_kps(img):
    orb = cv2.ORB_create(nfeatures=N_FEATURES, scaleFactor=1.2, nlevels=8,
                         fastThreshold=20)
    kps = orb.detect(img, None)
    return np.array([k.pt for k in kps]) if kps else np.zeros((0, 2))


def _occupancy(pts, shape=(480, 640), grid=GRID):
    gx = np.clip((pts[:, 0] * grid[0] / shape[1]).astype(int), 0, grid[0] - 1)
    gy = np.clip((pts[:, 1] * grid[1] / shape[0]).astype(int), 0, grid[1] - 1)
    occ = np.zeros(grid, bool)
    occ[gx, gy] = True
    return occ.mean()


def test_keypoint_spatial_coverage(textured_frame):
    """Per-cell argmax must cover the frame at least as uniformly as
    cv2.ORB's quadtree-balanced output (that is the whole point of the
    reference's DistributeOctTree)."""
    ours = _our_kps(textured_frame)
    cvs = _cv_kps(textured_frame)
    assert len(ours) >= 0.8 * N_FEATURES
    occ_ours = _occupancy(ours)
    occ_cv = _occupancy(cvs)
    # grid argmax is *more* uniform by construction; allow tiny slack for
    # border cells our selection grid clips
    assert occ_ours >= occ_cv - 0.05, (
        f"coverage {occ_ours:.3f} vs cv2 {occ_cv:.3f}"
    )


def _repeatability(extract, img, H, shape=(480, 640)):
    """Fraction of keypoints re-detected within REPEAT_TOL_PX under a
    known homography warp (the standard detector-repeatability metric)."""
    warped = cv2.warpPerspective(img, H, (shape[1], shape[0]))
    k1 = extract(img)
    k2 = extract(warped)
    if len(k1) == 0 or len(k2) == 0:
        return 0.0
    ones = np.ones((len(k1), 1))
    k1h = (np.concatenate([k1, ones], 1) @ H.T)
    k1w = k1h[:, :2] / k1h[:, 2:3]
    inside = ((k1w[:, 0] > 20) & (k1w[:, 0] < shape[1] - 20)
              & (k1w[:, 1] > 20) & (k1w[:, 1] < shape[0] - 20))
    k1w = k1w[inside]
    d = np.sqrt(((k1w[:, None, :] - k2[None, :, :]) ** 2).sum(-1))
    return float((d.min(axis=1) < REPEAT_TOL_PX).mean())


def test_keypoint_repeatability(textured_frame):
    """Warp repeatability within 10 points of cv2.ORB (absolute %)."""
    ang = np.deg2rad(4.0)
    c, s = np.cos(ang), np.sin(ang)
    cx, cy = 320.0, 240.0
    H = np.array([
        [c, -s, cx - c * cx + s * cy + 6.0],
        [s, c, cy - s * cx - c * cy - 4.0],
        [0.0, 0.0, 1.0],
    ])
    r_ours = _repeatability(_our_kps, textured_frame, H)
    r_cv = _repeatability(_cv_kps, textured_frame, H)
    assert r_ours > 0.35, f"repeatability collapsed: {r_ours:.3f}"
    assert r_ours >= r_cv - 0.10, (
        f"repeatability {r_ours:.3f} vs cv2 {r_cv:.3f}"
    )


def test_keypoint_mutual_agreement(textured_frame):
    """A majority of our keypoints coincide with a cv2.ORB keypoint
    (same FAST corners surviving both selection schemes)."""
    ours = _our_kps(textured_frame)
    cvs = _cv_kps(textured_frame)
    d = np.sqrt(((ours[:, None, :] - cvs[None, :, :]) ** 2).sum(-1))
    agree = float((d.min(axis=1) < REPEAT_TOL_PX).mean())
    assert agree > 0.5, f"only {agree:.2f} of our keypoints near cv2's"


# ---------------------------------------------------------------------------
# (b) fixed-budget 8-point vs adaptive 5-point: inlier-ratio sweep
# ---------------------------------------------------------------------------

FOCAL = 500.0
N_PTS = 400
N_SAMPLES = 1024          # ransac_essential's default fixed budget
ERR_TOL_DEG = 2.0


def _synth_normalised(outlier_frac, seed, n=N_PTS, noise_px=0.5):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-4, -3, 4], [4, 3, 12], (n, 3))
    from scipy.spatial.transform import Rotation as Rsc

    axis = rng.normal(size=3)
    R = Rsc.from_rotvec(np.deg2rad(6.0) * axis / np.linalg.norm(axis))
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    X2 = X @ R.as_matrix().T + t
    p1 = X[:, :2] / X[:, 2:3]
    p2 = X2[:, :2] / X2[:, 2:3]
    p1 += rng.normal(0, noise_px / FOCAL, p1.shape)
    p2 += rng.normal(0, noise_px / FOCAL, p2.shape)
    n_out = int(round(outlier_frac * n))
    idx = rng.choice(n, n_out, replace=False)
    p2[idx] = rng.uniform([-0.6, -0.45], [0.6, 0.45], (n_out, 2))
    return p1, p2, R.as_matrix()


def _rot_err_deg(Ra, Rb):
    q1 = np.asarray(so3.rotmat_to_quat(Ra))
    q2 = np.asarray(so3.rotmat_to_quat(Rb))
    return np.degrees(float(so3.qgeodesic(q1, q2)))


def _ours_rot_err(p1, p2, seed):
    import jax.numpy as jnp
    from irotavg_tpu.geometry.essential import (ransac_essential,
                                                recover_pose)

    valid = jnp.ones(len(p1), bool)
    E, inl, _ = ransac_essential(
        jnp.asarray(p1), jnp.asarray(p2), valid, jax.random.key(seed),
        th_norm=1.0 / FOCAL, n_samples=N_SAMPLES,
    )
    R, t, _, _ = recover_pose(E, jnp.asarray(p1), jnp.asarray(p2), inl)
    return np.asarray(R)


def _cv_rot_err(p1, p2):
    E, _ = cv2.findEssentialMat(
        p1, p2, focal=1.0, pp=(0.0, 0.0), method=cv2.RANSAC, prob=0.999,
        threshold=1.0 / FOCAL,
    )
    if E is None:
        return None
    E = E[:3]
    _, R, t, _ = cv2.recoverPose(E, p1, p2)
    return R


def _success_rate(estimator, ratio, n_trials=4):
    ok = 0
    for s in range(n_trials):
        p1, p2, R_gt = _synth_normalised(1.0 - ratio, seed=100 * s + 1)
        R = estimator(p1, p2, 1000 + s) if estimator is _ours_rot_err \
            else estimator(p1, p2)
        if R is not None and _rot_err_deg(R, R_gt) < ERR_TOL_DEG:
            ok += 1
    return ok / n_trials


def test_inlier_ratio_sweep():
    """Sweep inlier ratio 0.9 -> 0.3; assert ours is reliable through the
    SLAM operating band (>= 0.6) and pin the fixed-budget break point.

    Theory: P(success) = 1-(1-eps^8)^S.  S=1024 gives ~1.0 at eps=0.6,
    ~0.98 at 0.5, ~0.49 at 0.4, ~0.07 at 0.3 — the sweep should track
    this curve, and the adaptive 5-point keeps working below it.  The
    divergence is acceptable because the match sets RANSAC actually sees
    are pre-gated (ratio test, rotation histogram, epipolar distance) to
    well above 60% inliers; raw unmatched soups never reach it.
    """
    sweep = {}
    for ratio in (0.9, 0.7, 0.6, 0.5):
        sweep[ratio] = _success_rate(_ours_rot_err, ratio)
    # operating band: must be solid
    assert sweep[0.9] == 1.0, f"sweep={sweep}"
    assert sweep[0.7] == 1.0, f"sweep={sweep}"
    assert sweep[0.6] >= 0.75, f"sweep={sweep}"
    # break region: document (not require) degradation at 0.35 — with
    # eps^8 = 2.3e-4 the expected success is ~21%; any flakiness here is
    # the designed-in budget limit, not a regression
    low = _success_rate(_ours_rot_err, 0.35, n_trials=2)
    print(f"inlier-ratio sweep (ours, S={N_SAMPLES}): {sweep}, 0.35: {low}")


def test_adaptive_5pt_oracle_still_works_below_break():
    """cv2's adaptive 5-point succeeds at a ratio where the fixed budget
    is expected to fail — the documented cost of static shapes.  (If this
    ever fails, the synthetic problem is broken, not the solver.)"""
    rate_cv = _success_rate(_cv_rot_err, 0.4)
    assert rate_cv >= 0.75, f"cv2 5-point rate at 0.4: {rate_cv}"


def test_ours_matches_cv_in_operating_band():
    """At a realistic post-gating ratio (0.8) both estimators agree with
    GT and with each other."""
    p1, p2, R_gt = _synth_normalised(0.2, seed=42)
    R_ours = _ours_rot_err(p1, p2, 5)
    R_cv = _cv_rot_err(p1, p2)
    assert _rot_err_deg(R_ours, R_gt) < 1.0
    assert _rot_err_deg(R_cv, R_gt) < 1.0
    assert _rot_err_deg(R_ours, R_cv) < 1.5
