"""Synthetic image-sequence generators with known camera trajectories.

Renders textured 3-D planes through a moving pinhole camera (each quad is
a homography warp of its texture), giving real parallax so essential-
matrix geometry is well-posed.  Ground-truth rotations are returned for
trajectory-error checks — the stand-in for KITTI in this environment
(no dataset access; see BASELINE.md config 3).

Two worlds:

* :func:`make_sequence` — a wall of staggered planes swept laterally,
  optionally as ``passes`` out-and-back round trips.  Note that reversing
  trajectories largely CANCEL accumulated odometry error (each return
  leg retraces reversed edges), so they under-state drift.
* :func:`make_ring_sequence` — a camera orbiting inside a ring of
  textured panels with monotone yaw (the KITTI-00 "drive around the
  block" analogue): motion never reverses, so odometry drift accumulates
  monotonically, and each completed lap is a genuine revisit for place
  recognition.  This is the loop-closure payoff workload.

Optional degradations on both: sensor noise, optical blur, radial lens
distortion (k1/k2 — the caller must build its Camera with the same
coefficients so the undistortKeypoints path runs, src/Frame.cpp:102-139).

The renderer is numpy + scipy only, so every machine renders the same
frames.  Its primitives follow OpenCV's definitions (the library the
reference links): ``GaussianBlur`` kernel radius and REFLECT_101 border,
inclusive filled rectangles, filled discs ``d^2 <= r^2``, bilinear warps
on a 1/32-pixel coordinate grid with a zero border (``warpPerspective``)
or an edge-replicating one (``remap``).
"""

import numpy as np
from scipy.ndimage import gaussian_filter
from scipy.spatial.transform import Rotation as Rsc


def _blur(img, sigma):
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` for uint8 images."""
    radius = int(round(sigma * 6 + 1)) // 2      # cvRound(6 sigma + 1) | 1
    out = gaussian_filter(img.astype(np.float64), sigma, mode="mirror",
                          radius=radius)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _texture(rng, size=400):
    tex = _blur(rng.integers(60, 200, (size, size), np.uint8), 1.2)
    for _ in range(60):
        p = rng.integers(10, size - 30, 2)
        w, h = rng.integers(6, 30, 2)
        tex[p[1]:p[1] + h + 1, p[0]:p[0] + w + 1] = int(rng.integers(0, 255))
    yy, xx = np.mgrid[:size, :size]
    for _ in range(40):
        cx, cy = (int(v) for v in rng.integers(15, size - 15, 2))
        r = int(rng.integers(3, 12))
        tex[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = int(rng.integers(0, 255))
    return tex


def _homography(src, dst):
    """The 3x3 H with H @ [src, 1] ~ [dst, 1] for 4 point pairs
    (``cv2.getPerspectiveTransform``)."""
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for k, ((x, y), (u, v)) in enumerate(zip(src, dst)):
        A[2 * k] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        A[2 * k + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * k], b[2 * k + 1] = u, v
    return np.append(np.linalg.solve(A, b), 1.0).reshape(3, 3)


def _bilinear(img, xs, ys, replicate):
    """Sample ``img`` at float coordinates, OpenCV INTER_LINEAR style.

    Returns (values, coverage): with ``replicate`` the border pixels
    extend outward (BORDER_REPLICATE) and coverage is all ones; otherwise
    outside pixels read 0 (BORDER_CONSTANT) and coverage is the bilinear
    weight that fell inside the image.
    """
    h, w = img.shape
    xs = np.round(xs * 32.0) / 32.0               # INTER_BITS = 5
    ys = np.round(ys * 32.0) / 32.0
    x0 = np.floor(xs)
    y0 = np.floor(ys)
    fx = xs - x0
    fy = ys - y0
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)
    val = np.zeros(xs.shape)
    cov = np.zeros(xs.shape)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            wgt = wx * wy
            if replicate:
                inside = np.ones(xs.shape, bool)
            else:
                inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            pix = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
            val += np.where(inside, wgt * pix, 0.0)
            cov += np.where(inside, wgt, 0.0)
    return val, cov


def _warp_quad(canvas, tex, H):
    """Paint ``tex`` warped by H over ``canvas`` where the warped texture
    mask exceeds 128 of 255 (``warpPerspective`` of the texture and of an
    all-255 mask, both INTER_LINEAR)."""
    h, w = canvas.shape
    th, tw = tex.shape
    corners = np.array([[0, 0, 1], [tw, 0, 1], [tw, th, 1], [0, th, 1]],
                       float) @ H.T
    corners = corners[:, :2] / corners[:, 2:3]
    x_lo = max(int(np.floor(corners[:, 0].min())) - 2, 0)
    x_hi = min(int(np.ceil(corners[:, 0].max())) + 3, w)
    y_lo = max(int(np.floor(corners[:, 1].min())) - 2, 0)
    y_hi = min(int(np.ceil(corners[:, 1].max())) + 3, h)
    if x_lo >= x_hi or y_lo >= y_hi:
        return
    u, v = np.meshgrid(np.arange(x_lo, x_hi, dtype=np.float64),
                       np.arange(y_lo, y_hi, dtype=np.float64))
    Hi = np.linalg.inv(H)
    den = Hi[2, 0] * u + Hi[2, 1] * v + Hi[2, 2]
    xs = (Hi[0, 0] * u + Hi[0, 1] * v + Hi[0, 2]) / den
    ys = (Hi[1, 0] * u + Hi[1, 1] * v + Hi[1, 2]) / den
    val, cov = _bilinear(tex, xs, ys, replicate=False)
    sub = canvas[y_lo:y_hi, x_lo:x_hi]
    paint = np.rint(cov * 255.0) > 128
    sub[paint] = np.clip(np.rint(val[paint]), 0, 255).astype(np.uint8)


def _distortion_maps(K, k1, k2, size):
    """Sampling maps that APPLY radial distortion to an ideal pinhole
    render: distorted(p_d) = ideal(undistort(p_d)).  Uses the same
    fixed-point undistortion scheme as the runtime Camera
    (cv::undistortPoints; src/Frame.cpp:102-139 consumes the inverse)."""
    w, h = size
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    xd = (u - cx) / fx
    yd = (v - cy) / fy
    xu, yu = xd, yd
    for _ in range(5):
        r2 = xu * xu + yu * yu
        k_radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xu = xd / k_radial
        yu = yd / k_radial
    return ((xu * fx + cx).astype(np.float32),
            (yu * fy + cy).astype(np.float32))


def _render_frame(planes, R, t, K, size, rng, dist_maps,
                  blur_sigma, noise_sigma, depth_of=None):
    """Project textured quads for one pose and apply the degradations.

    ``planes`` is a list of (corners (4,3), texture); quads are drawn
    far-to-near by camera-space depth.
    """
    w, h = size
    canvas = np.full((h, w), 90, np.uint8)
    cams = [(corners @ R.T + t, tex) for corners, tex in planes]
    cams = [(cam, tex) for cam, tex in cams if (cam[:, 2] > 0.5).all()]
    cams.sort(key=lambda ct: -ct[0][:, 2].mean())    # far to near
    for cam, tex in cams:
        proj = cam @ K.T
        proj = proj[:, :2] / proj[:, 2:3]
        if (np.abs(proj) > 8 * max(w, h)).any():
            continue                                  # wildly off-screen
        src = np.array([[0, 0], [tex.shape[1], 0],
                        [tex.shape[1], tex.shape[0]], [0, tex.shape[0]]],
                       np.float32)
        _warp_quad(canvas, tex,
                   _homography(src, proj.astype(np.float32).astype(float)))
    if dist_maps is not None:
        val, _ = _bilinear(canvas, dist_maps[0], dist_maps[1],
                           replicate=True)
        canvas = np.clip(np.rint(val), 0, 255).astype(np.uint8)
    if blur_sigma > 0:
        canvas = _blur(canvas, blur_sigma)
    if noise_sigma > 0:
        canvas = np.clip(
            canvas.astype(np.float32)
            + rng.normal(scale=noise_sigma, size=canvas.shape),
            0, 255,
        ).astype(np.uint8)
    return canvas


def make_sequence(n_frames=15, size=(640, 480), fx=500.0, seed=0,
                  step=0.25, yaw_deg_per_frame=0.8, loop=False, passes=1,
                  noise_sigma=0.0, blur_sigma=0.0, k1=0.0, k2=0.0):
    """Returns (frames [uint8 images], K, R_gt (n,3,3) world->cam)."""
    rng = np.random.default_rng(seed)
    w, h = size
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]])
    dist_maps = _distortion_maps(K, k1, k2, size) if k1 != 0.0 else None

    # planes: big background + staggered foreground panels (parallax)
    planes = []
    for z, span, cx_off in [(14.0, 16.0, 0.0), (8.0, 3.0, -3.0),
                            (7.0, 2.5, 2.0), (9.0, 3.0, 6.0),
                            (8.5, 2.5, 9.5), (7.5, 2.5, -6.0)]:
        tex = _texture(rng)
        corners = np.array([
            [cx_off - span / 2, -span / 2.5, z],
            [cx_off + span / 2, -span / 2.5, z],
            [cx_off + span / 2, span / 2.5, z],
            [cx_off - span / 2, span / 2.5, z],
        ])
        planes.append((corners, tex))

    if loop and passes > 1:
        # triangle-wave sweep: ``passes`` out-and-back round trips over
        # the same span, each leg offset by 0.21 of a step so no two
        # poses ever coincide (a full stop livelocks the adaptive search
        # radius — in the reference too, src/ViewGraph.cpp:840,893)
        seg = max(n_frames // (2 * passes), 2)
        t_ = np.arange(n_frames)
        phase = t_ % (2 * seg)
        tri = np.where(phase < seg, phase, 2 * seg - phase).astype(float)
        leg = t_ // seg            # increments each half-pass
        u = tri + 0.21 * (leg % 4)
        yaws = u * yaw_deg_per_frame
        xs = u * step
    elif loop:
        # single out-and-back revisiting the start; the return pass is
        # offset by half a step (same no-coincidence rationale)
        h1 = n_frames // 2
        h2 = n_frames - h1
        fwd = np.arange(h1, dtype=np.float64)
        back = h1 - 1.5 - np.arange(h2)
        yaws = np.concatenate([fwd, back]) * yaw_deg_per_frame
        xs = np.concatenate([fwd, back]) * step
    else:
        yaws = np.arange(n_frames) * yaw_deg_per_frame
        xs = np.arange(n_frames) * step

    frames, R_gt = [], []
    for k in range(n_frames):
        R = Rsc.from_euler("y", yaws[k], degrees=True).as_matrix()
        C = np.array([xs[k], 0.02 * k if not loop else 0.0, 0.0])
        t = -R @ C
        frames.append(_render_frame(planes, R, t, K, size, rng, dist_maps,
                                    blur_sigma, noise_sigma))
        R_gt.append(R)
    return frames, K, np.stack(R_gt)


def make_ring_sequence(n_frames=240, size=(640, 480), fx=500.0, seed=0,
                       laps=2.0, cam_radius=4.0, noise_sigma=0.0,
                       blur_sigma=0.0, k1=0.0, k2=0.0):
    """One-way loop: the camera orbits inside a ring of textured panels,
    looking radially outward, yaw monotone over ``laps`` full circles.

    Returns (frames, K, R_gt (n,3,3) world->cam).  Because the motion
    never reverses, per-edge odometry errors accumulate monotonically —
    after one lap the trajectory genuinely revisits its start with the
    full accumulated drift, which is exactly what loop closure exists to
    correct (src/IRotAvg.cpp:295-353).  Subsequent laps shrink the orbit
    radius by 2% each so no two poses coincide.
    """
    rng = np.random.default_rng(seed)
    w, h = size
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]])
    dist_maps = _distortion_maps(K, k1, k2, size) if k1 != 0.0 else None

    # concentric rings of panels: a continuous far wall plus sparse
    # smaller foreground panels at two depths, so every view mixes
    # several depth layers (a single dominant plane would make the
    # essential matrix planar-degenerate every frame)
    planes = []
    rings = (
        # radius, n_panels, span_fill, height, y offsets cycle
        (16.0, 14, 1.04, 8.0, (0.0,)),
        (11.0, 9, 0.42, 3.4, (-1.6, 1.8)),
        (7.5, 7, 0.30, 2.2, (1.2, -1.0, 0.2)),
    )
    for radius, n_panels, fill, height, y0s in rings:
        span = 2 * np.pi * radius / n_panels * fill
        for p in range(n_panels):
            phi = 2 * np.pi * (p + (radius * 7 % 1.0)) / n_panels
            # panel centre, facing the ring centre
            cx, cz = radius * np.sin(phi), radius * np.cos(phi)
            tx, tz = np.cos(phi), -np.sin(phi)        # tangent direction
            y0 = y0s[p % len(y0s)]
            c = np.array([cx, y0, cz])
            tvec = np.array([tx, 0.0, tz]) * span / 2
            up = np.array([0.0, height / 2, 0.0])
            corners = np.stack([c - tvec - up, c + tvec - up,
                                c + tvec + up, c - tvec + up])
            planes.append((corners, _texture(rng)))

    frames, R_gt = [], []
    for kf in range(n_frames):
        phi = 2 * np.pi * laps * kf / n_frames
        r_k = cam_radius * (1.0 - 0.02 * (phi // (2 * np.pi)))
        C = np.array([r_k * np.sin(phi), 0.0, r_k * np.cos(phi)])
        # optical axis = radial direction (sin phi, 0, cos phi):
        # world->cam R = R_y(-phi) in scipy's convention maps it to +z
        R = Rsc.from_euler("y", -phi).as_matrix()
        t = -R @ C
        frames.append(_render_frame(planes, R, t, K, size, rng, dist_maps,
                                    blur_sigma, noise_sigma))
        R_gt.append(R)
    return frames, K, np.stack(R_gt)
