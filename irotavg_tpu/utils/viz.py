"""Match visualisation — headless counterpart of the reference's GUI.

The reference pops cv::imshow windows with cv::drawMatches output
unconditionally inside processFrame and on loop closures (`plotMatches` /
`myPlotMatches`, src/IRotAvg.cpp:93-107; src/ViewGraph.cpp:653-667).  A
server deployment is headless, so the same observable — the two frames side by
side with keypoint marks and match lines — is rendered to an RGB array
with pure numpy and optionally written to a PNG.  Enable from the CLI with
``--plot_matches DIR``.
"""

from __future__ import annotations

import numpy as np

from irotavg_tpu.utils.png import write_png

# A small qualitative palette so neighbouring lines are distinguishable
# (cv::drawMatches uses random colours; fixed palette keeps output
# deterministic for tests).
_PALETTE = np.array(
    [
        [230, 97, 0],
        [93, 58, 155],
        [26, 133, 255],
        [212, 17, 89],
        [64, 176, 166],
        [255, 194, 10],
        [153, 79, 0],
        [60, 180, 75],
    ],
    np.uint8,
)


def _to_rgb(im) -> np.ndarray:
    im = np.asarray(im)
    if im.dtype != np.uint8:
        lo, hi = float(im.min()), float(im.max())
        scale = 255.0 / (hi - lo) if hi > lo else 1.0
        im = ((im - lo) * scale).astype(np.uint8)
    if im.ndim == 2:
        im = np.repeat(im[:, :, None], 3, axis=2)
    return im


def _draw_line(canvas: np.ndarray, x0, y0, x1, y1, color) -> None:
    """Rasterise one line segment by dense parametric sampling (numpy)."""
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
    t = np.linspace(0.0, 1.0, n)
    xs = np.clip(np.round(x0 + t * (x1 - x0)).astype(int), 0,
                 canvas.shape[1] - 1)
    ys = np.clip(np.round(y0 + t * (y1 - y0)).astype(int), 0,
                 canvas.shape[0] - 1)
    canvas[ys, xs] = color


def _draw_marker(canvas: np.ndarray, x, y, color, r: int = 3) -> None:
    h, w = canvas.shape[:2]
    x, y = int(round(x)), int(round(y))
    yy, xx = np.ogrid[max(0, y - r):min(h, y + r + 1),
                      max(0, x - r):min(w, x + r + 1)]
    ring = np.abs((yy - y) ** 2 + (xx - x) ** 2 - r * r) <= r
    canvas[max(0, y - r):min(h, y + r + 1),
           max(0, x - r):min(w, x + r + 1)][ring] = color


def draw_matches(im1, xy1, im2, xy2, pairs, max_lines: int = 500
                 ) -> np.ndarray:
    """Render two images side by side with match lines.

    Args:
      im1, im2: grayscale or RGB images (any numeric dtype).
      xy1, xy2: ``(N, 2)`` keypoint pixel coordinates per image.
      pairs:    ``(M, 2)`` int indices — ``pairs[k] = (i1, i2)`` matches
                ``xy1[i1]`` with ``xy2[i2]`` (FeatureMatches semantics).
      max_lines: cap on rendered lines (subsampled evenly beyond this).

    Returns an ``(H, W1+W2, 3)`` uint8 canvas (cv::drawMatches layout).
    """
    im1, im2 = _to_rgb(im1), _to_rgb(im2)
    xy1 = np.asarray(xy1, np.float64).reshape(-1, 2)
    xy2 = np.asarray(xy2, np.float64).reshape(-1, 2)
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    h = max(im1.shape[0], im2.shape[0])
    w1, w2 = im1.shape[1], im2.shape[1]
    canvas = np.zeros((h, w1 + w2, 3), np.uint8)
    canvas[: im1.shape[0], :w1] = im1
    canvas[: im2.shape[0], w1:] = im2

    if len(pairs) > max_lines:
        pairs = pairs[:: int(np.ceil(len(pairs) / max_lines))]
    for k, (i1, i2) in enumerate(pairs):
        color = _PALETTE[k % len(_PALETTE)]
        x0, y0 = xy1[i1]
        x1, y1 = xy2[i2][0] + w1, xy2[i2][1]
        _draw_line(canvas, x0, y0, x1, y1, color)
        _draw_marker(canvas, x0, y0, color)
        _draw_marker(canvas, x1, y1, color)
    return canvas


def save_png(path: str, image: np.ndarray) -> None:
    """Write a gray or RGB(A) uint8 image array to PNG."""
    write_png(path, image)


def plot_matches(frame1, frame2, pairs, path: str | None = None,
                 **kw) -> np.ndarray:
    """`myPlotMatches` (src/IRotAvg.cpp:93-107) for Frame objects.

    Frames must have been created with ``keep_image=True`` so the pixel
    data is retained.  ``pairs[k] = (idx in frame1, idx in frame2)``.
    """
    for f in (frame1, frame2):
        if getattr(f, "image", None) is None:
            raise ValueError(
                "plot_matches needs frames built with keep_image=True"
            )
    canvas = draw_matches(
        frame1.image, np.stack([frame1.x, frame1.y], axis=1),
        frame2.image, np.stack([frame2.x, frame2.y], axis=1),
        pairs, **kw,
    )
    if path is not None:
        save_png(path, canvas)
    return canvas
