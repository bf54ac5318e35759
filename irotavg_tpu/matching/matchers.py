"""Descriptor matchers as masked reductions over the Hamming matrix.

Parity contracts (src/ViewGraph.cpp):

* ``match_by_bow``    — `findORBMatchesByBoW` (:125-295): candidates share a
  vocabulary node; best/second-best with ratio ``d1 < nnratio*d2`` and
  ``d1 <= TH_LOW``; rotation-histogram pruning; one match per target.
* ``match_epipolar``  — `findORBMatches` (:298-437): candidates share a
  node AND satisfy the epipolar gate ``dist^2 < 3.84 sigma^2(octave1)``
  for the line of p2 mapped by F12 (the reference calls
  `checkDistEpipolarLine(kp2, kp1, F12)`, :40-61, i.e. line = F12^T p2
  evaluated at p1); best under TH_LOW, no ratio test; rotation pruning.
* ``match_locally``   — `findORBMatchesLocally` (:440-569): candidates lie
  within ``radius`` px of a per-keypoint guess position and within +/-2
  octaves; ratio test; stealing resolved by keeping the smaller distance
  per target (the reference's order-dependent steal converges to the
  same in all but adversarial ties); no rotation pruning.

Divergences (documented, deliberate):
* conflict resolution for a contested target keeps the globally smallest
  distance rather than the reference's scan-order first/last-wins;
* the rotation histogram replicates the reference's ``bin =
  round(delta_deg / 30)`` quirk (only bins 0..12 ever populated —
  inherited from ORB-SLAM2) so pruning behavior matches.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from irotavg_tpu.ops.hamming import (
    best2, make_colft, make_rowf, unpack_pm1,
)

TH_LOW = 50          # src/ViewGraph.cpp:33
HISTO_LENGTH = 30    # src/ViewGraph.cpp:32
_BIG = 10_000


def _best_two(bits1, bits2t, rowf, colft, gate):
    """Per-row best/second distances + best index over gated columns
    (ops/hamming.py).  Distances come back as exact integers in f32;
    downstream logic uses int32 (the conflict-resolution key needs integer
    arithmetic)."""
    d1, d2, best_idx = best2(bits1, bits2t, rowf, colft, gate)
    return (d1.astype(jnp.int32), d2.astype(jnp.int32),
            best_idx.astype(jnp.int64))


def _resolve_conflicts(matches12, dists, n2):
    """Keep, for each contested target j, the row with minimal distance
    (ties -> smaller row index)."""
    n1 = matches12.shape[0]
    j = jnp.where(matches12 >= 0, matches12, n2)  # padded row -> virtual col
    key = dists * (n1 + 1) + jnp.arange(n1)       # unique, orders by (dist, i)
    best_key = (
        jnp.full((n2 + 1,), _BIG * (n1 + 1) + n1, key.dtype)
        .at[j]
        .min(key)
    )
    winner = best_key[j] == key
    return jnp.where((matches12 >= 0) & winner, matches12, -1)


def _rot_bins(angle1_rad, angle2_rad, matches12):
    """The reference's histogram bin per row (quirk included)."""
    a1 = jnp.degrees(angle1_rad)
    a2 = jnp.degrees(angle2_rad)
    rot = a1 - a2[jnp.clip(matches12, 0, None)]
    rot = jnp.where(rot < 0, rot + 360.0, rot)
    bins = jnp.round(rot * (1.0 / HISTO_LENGTH)).astype(jnp.int32)
    return jnp.where(bins == HISTO_LENGTH, 0, bins)


@functools.partial(jax.jit, inline=True)
def rotation_consistency_filter(matches12, angle1_rad, angle2_rad):
    """Drop matches outside the 3 dominant rotation-histogram bins
    (`computeThreeMaxima`, src/ViewGraph.cpp:64-103: second/third maxima
    kept only if >= 0.1x the first)."""
    bins = _rot_bins(angle1_rad, angle2_rad, matches12)
    valid = matches12 >= 0
    counts = (
        jnp.zeros((HISTO_LENGTH,), jnp.int32)
        .at[jnp.where(valid, bins, 0)]
        .add(valid.astype(jnp.int32))
    )
    c1 = jnp.max(counts)
    i1 = jnp.argmax(counts)
    counts2 = counts.at[i1].set(-1)
    c2 = jnp.max(counts2)
    i2 = jnp.argmax(counts2)
    counts3 = counts2.at[i2].set(-1)
    c3 = jnp.max(counts3)
    i3 = jnp.argmax(counts3)

    keep2 = c2.astype(jnp.float32) >= 0.1 * c1.astype(jnp.float32)
    keep3 = c3.astype(jnp.float32) >= 0.1 * c1.astype(jnp.float32)
    ok = (bins == i1) | (keep2 & (bins == i2)) | (keep2 & keep3 & (bins == i3))
    return jnp.where(valid & ok, matches12, -1)


@functools.partial(jax.jit, inline=True,
                   static_argnames=("check_orientation", "has_nodes"))
def _match_by_bow_core(bits1, nodes1, valid1, angle1,
                       bits2t, nodes2, valid2, angle2,
                       nnratio, check_orientation=True, has_nodes=True):
    rowf = make_rowf(valid1, node=nodes1)
    colft = make_colft(valid2, node=nodes2)
    d1, d2, best = _best_two(bits1, bits2t, rowf, colft,
                             "node" if has_nodes else "none")
    ok = (d1 <= TH_LOW) & (d1.astype(jnp.float32) < nnratio * d2.astype(jnp.float32))
    matches12 = jnp.where(ok, best, -1)
    matches12 = _resolve_conflicts(matches12, d1, bits2t.shape[1])
    if check_orientation:
        matches12 = rotation_consistency_filter(matches12, angle1, angle2)
    return matches12


@functools.partial(jax.jit, inline=True, static_argnames=("has_nodes",))
def _match_epipolar_core(bits1, nodes1, valid1, angle1, x1, y1, oct1,
                         bits2t, nodes2, valid2, angle2, x2, y2,
                         F12, sigma2_oct, has_nodes=True):
    # line of p2 through F12^T, evaluated at p1 (reference arg order)
    a = x2 * F12[0, 0] + y2 * F12[1, 0] + F12[2, 0]
    b = x2 * F12[0, 1] + y2 * F12[1, 1] + F12[2, 1]
    c = x2 * F12[0, 2] + y2 * F12[1, 2] + F12[2, 2]
    th = 3.84 * sigma2_oct[oct1]
    rowf = make_rowf(valid1, node=nodes1, x=x1, y=y1, th=th)
    colft = make_colft(valid2, node=nodes2, a=a, b=b, c=c)
    gate = "epipolar" if has_nodes else "epipolar_nonode"
    d1, _, best = _best_two(bits1, bits2t, rowf, colft, gate)
    matches12 = jnp.where(d1 <= TH_LOW, best, -1)
    matches12 = _resolve_conflicts(matches12, d1, bits2t.shape[1])
    return rotation_consistency_filter(matches12, angle1, angle2)


@functools.partial(jax.jit, inline=True)
def _match_locally_core(bits1, valid1, oct1, gx, gy,
                        bits2t, valid2, oct2, x2, y2,
                        radius, nnratio):
    # square search window (the reference's grid query is a box, then
    # per-cell rectangles; Frame::getFeaturesInArea filters |dx|,|dy| <= r)
    rowf = make_rowf(valid1, x=gx, y=gy, octave=oct1,
                     th=jnp.full(gx.shape, radius, jnp.float32))
    colft = make_colft(valid2, x=x2, y=y2, octave=oct2)
    d1, d2, best = _best_two(bits1, bits2t, rowf, colft, "local")
    ok = (d1 <= TH_LOW) & (d1.astype(jnp.float32) < nnratio * d2.astype(jnp.float32))
    matches12 = jnp.where(ok, best, -1)
    return _resolve_conflicts(matches12, d1, bits2t.shape[1])


# -- Frame-level wrappers ---------------------------------------------------


def _nodes(f):
    """Device copy of feat_nodes, cached on the Frame — a fresh
    ``jnp.asarray`` upload per matcher call is its own dispatch."""
    if f.feat_nodes is None:
        return None
    d = getattr(f, "dev", None)
    return d("feat_nodes") if d is not None else jnp.asarray(f.feat_nodes)


def _bits(f):
    """Cached ±1 expansion (Frame.pm1) or a one-off unpack for frame-like
    test doubles."""
    pm1 = getattr(f, "pm1", None)
    return pm1 if pm1 is not None else unpack_pm1(f.desc)


def _dev(f, name):
    """Cached device array (Frame.dev) or a one-off upload for frame-like
    test doubles."""
    d = getattr(f, "dev", None)
    if d is not None:
        return d(name)
    v = getattr(f, name)
    return jnp.asarray(
        v, jnp.float32 if name in ("xu", "yu", "angle") else None
    )


def match_by_bow(f1, f2, nnratio: float = 0.9):
    """BoW-guided matching between two Frames -> (N1,) matches12."""
    n1, n2 = _nodes(f1), _nodes(f2)
    return np.asarray(_match_by_bow_core(
        _bits(f1), n1, _dev(f1, "valid"), _dev(f1, "angle"),
        _bits(f2).T, n2, _dev(f2, "valid"), _dev(f2, "angle"),
        np.float32(nnratio),
        has_nodes=n1 is not None and n2 is not None,
    ))


def match_epipolar(f1, f2, F12, scale_factor: float = 1.2):
    """Epipolar-gated matching (undistorted coords) -> (N1,) matches12."""
    n_oct = int(max(f1.octave.max(), f2.octave.max())) + 1
    sigma2 = jnp.asarray(
        (scale_factor ** np.arange(max(n_oct, 8))) ** 2, jnp.float32
    )
    n1, n2 = _nodes(f1), _nodes(f2)
    return np.asarray(_match_epipolar_core(
        _bits(f1), n1, _dev(f1, "valid"),
        _dev(f1, "angle"), _dev(f1, "xu"),
        _dev(f1, "yu"), _dev(f1, "octave"),
        _bits(f2).T, n2, _dev(f2, "valid"),
        _dev(f2, "angle"), _dev(f2, "xu"), _dev(f2, "yu"),
        jnp.asarray(F12, jnp.float32), sigma2,
        has_nodes=n1 is not None and n2 is not None,
    ))


def match_locally(f1, f2, guess_xy=None, radius: float = 100.0,
                  nnratio: float = 0.9):
    """Window search around guess positions (defaults to f1's own
    keypoints — the motion-free guess of `findCurr2PrevLocalMatches`,
    src/ViewGraph.cpp:574-596) -> (N1,) matches12."""
    if guess_xy is None:
        gx, gy = f1.xu, f1.yu
    else:
        gx, gy = guess_xy
    return np.asarray(_match_locally_core(
        _bits(f1), _dev(f1, "valid"), _dev(f1, "octave"),
        jnp.asarray(gx, jnp.float32), jnp.asarray(gy, jnp.float32),
        _bits(f2).T, _dev(f2, "valid"), _dev(f2, "octave"),
        _dev(f2, "xu"), _dev(f2, "yu"),
        jnp.float32(radius), jnp.float32(nnratio),
    ))


def matches_to_pairs(matches12) -> np.ndarray:
    """(N1,) assignment vector -> (M, 2) index pairs."""
    m = np.asarray(matches12)
    i = np.where(m >= 0)[0]
    return np.stack([i, m[i]], axis=1).astype(np.int32)


@jax.jit
def _match_sift_core(d1, valid1, d2t, valid2):
    # OpenCV SIFT descriptors are the L2-normalised vector scaled by 512;
    # scale here so the reference's absolute threshold keeps its meaning.
    a = d1 * 512.0
    b = d2t * 512.0
    # squared L2 via one matrix product: |a|^2 + |b|^2 - 2 a.b
    dist2 = (
        jnp.sum(a * a, axis=1)[:, None]
        + jnp.sum(b * b, axis=0)[None, :]
        - 2.0 * (a @ b)
    )
    gate = valid1[:, None] & valid2[None, :]
    dist2 = jnp.where(gate, jnp.maximum(dist2, 0.0), jnp.inf)
    j = jnp.argmin(dist2, axis=1)
    dmin = jnp.sqrt(jnp.take_along_axis(dist2, j[:, None], axis=1)[:, 0])
    finite = jnp.isfinite(dmin)
    global_min = jnp.min(jnp.where(finite, dmin, jnp.inf))
    # `good` filter of the reference: dist <= max(3*min_dist, 80.0)
    keep = finite & (dmin <= jnp.maximum(3.0 * global_min, 80.0))
    return jnp.where(keep, j, -1), dmin


def match_sift(f1, f2):
    """Nearest-neighbour L2 matching of SIFT descriptors with the
    reference's good-match filter ``d <= max(3*min_d, 80.0)`` —
    `findSIFTMatches` (src/ViewGraph.cpp:694-722; FLANN there, one exact
    distance matrix product here).  Returns a (N1,) assignment vector."""
    m12, _ = _match_sift_core(
        jnp.asarray(f1.desc, jnp.float32), _dev(f1, "valid"),
        jnp.asarray(f2.desc, jnp.float32).T, _dev(f2, "valid"),
    )
    return m12
