"""Batched look-ahead feature extraction for sequential drivers.

The incremental engine consumes frames one at a time (the keyframe gate
and the window walk are sequential decisions), but extraction is not: a
recorded sequence's images are all known ahead of the cursor.  Extracting
one image per dispatch leaves the device's batch dimension empty and pays
the per-dispatch overhead per frame; this prefetcher runs the same
pyramid program the offline pipeline uses (`pipeline/offline.py` stage 1)
over look-ahead batches, and hands the engine `Frame` objects whose
feature arrays are per-frame device buffers sliced INSIDE the batched
program (a host-side ``arr[k]`` on a device array would be its own
dispatch per slice — B x 8 of them per batch).

The app main loop stays step-for-step identical to the reference
(src/IRotAvg.cpp:251-392): only *when* extraction compute runs moves.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from irotavg_tpu.frontend.frame import Frame


def _undistort_xla(x, y, dist):
    """In-program iterative undistortion (the same fixed-point scheme as
    Camera.undistort_points / cv::undistortPoints).  Keeping this inside
    the batched extractor program keeps the host fallback's blocking
    fetch + two uploads PER FRAME off the per-frame path whenever
    k1 != 0 (src/Frame.cpp:102-139)."""
    import jax.numpy as jnp

    fx, fy, cx, cy, k1, k2, p1, p2 = dist
    xd = (x - cx) / fx
    yd = (y - cy) / fy
    xu, yu = xd, yd
    for _ in range(5):
        r2 = xu * xu + yu * yu
        k_radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu)
        dy = p1 * (r2 + 2 * yu * yu) + 2 * p2 * xu * yu
        xu = (xd - dx) / k_radial
        yu = (yd - dy) / k_radial
    return (xu * fx + cx).astype(jnp.float32), (
        yu * fy + cy).astype(jnp.float32)


@lru_cache(maxsize=8)
def _batched_extractor(h: int, w: int, batch: int, params, dist=None):
    """``dist``: optional (fx, fy, cx, cy, k1, k2, p1, p2) float tuple —
    when given, undistorted coordinates ride the same program."""
    import jax

    from irotavg_tpu.frontend.orb import _compiled_extractor

    single = _compiled_extractor(h, w, params)

    @jax.jit
    def run(imgs, th_hi, th_lo):
        out = jax.vmap(lambda im: single(im, th_hi, th_lo))(imgs)
        if dist is not None:
            out = dict(out)
            out["xu"], out["yu"] = _undistort_xla(
                out["x0"].astype(jax.numpy.float32),
                out["y0"].astype(jax.numpy.float32), dist)
        # split into per-frame pytrees inside the program: each frame's
        # arrays come back as separate output buffers, so downstream
        # consumers never slice a batched device array op-by-op
        return tuple(
            jax.tree.map(lambda a: a[b], out) for b in range(batch)
        )

    return run


def _dist_tuple(camera):
    if camera is None or not camera.has_distortion:
        return None
    return tuple(float(v) for v in (camera.fx, camera.fy, camera.cx,
                                    camera.cy, camera.k1, camera.k2,
                                    camera.p1, camera.p2))


def sample_descriptors(images, extractor, *, batch: int = 8,
                       cap: int = 400, stride: int = 1):
    """Valid descriptors per sampled image, via the BATCHED extractor.

    For vocabulary training samplers.  Uses the same batched program as
    :class:`FramePrefetcher` with one bundled fetch per batch — on the
    session backend the single-image extract program exhibits a
    pathological multi-minute first-call latency that the batched one
    does not, so samplers must not touch it.
    Returns a list of ``(n_i, 8)`` uint32 arrays (``n_i <= cap``).
    """
    import jax

    sel = list(range(0, len(images), stride))
    out = []
    for lo in range(0, len(sel), batch):
        ids = sel[lo:lo + batch]
        imgs = np.stack([np.asarray(images[i]) for i in ids])
        if len(ids) < batch:
            imgs = np.concatenate(
                [imgs, np.repeat(imgs[-1:], batch - len(ids), axis=0)]
            )
        run = _batched_extractor(imgs.shape[1], imgs.shape[2], batch,
                                 extractor.params)
        outs = run(imgs, np.float32(extractor.params.ini_th_fast),
                   np.float32(extractor.params.min_th_fast))
        fetched = jax.device_get(
            [(outs[k]["desc"], outs[k]["valid"]) for k in range(len(ids))]
        )
        out.extend(d[v][:cap] for d, v in fetched)
    return out


class FramePrefetcher:
    """Look-ahead batched extraction over a recorded image sequence.

    ``images`` is a sequence of arrays or callables returning arrays
    (lazy disk loading).  ``frame(i)`` returns the :class:`Frame` for
    image ``i``; the batch containing ``i`` is extracted on demand and
    the NEXT batch is dispatched eagerly, so its device compute overlaps
    the engine's matching/solving for the current batch.
    """

    def __init__(self, images, extractor, camera, *, batch: int = 8,
                 vocab=None):
        self.images = images
        self.extractor = extractor
        self.camera = camera
        self.batch = int(batch)
        self.vocab = vocab
        self._cache: dict[int, dict] = {}   # frame id -> device dict
        self._dispatched: set[int] = set()  # batch lo marks

    def _dispatch(self, lo: int) -> None:
        if lo in self._dispatched or lo >= len(self.images):
            return
        self._dispatched.add(lo)
        hi = min(lo + self.batch, len(self.images))
        imgs = np.stack([
            np.asarray(self.images[i]() if callable(self.images[i])
                       else self.images[i])
            for i in range(lo, hi)
        ])
        if hi - lo < self.batch:   # pad tail to reuse the executable
            imgs = np.concatenate(
                [imgs, np.repeat(imgs[-1:], self.batch - (hi - lo), axis=0)]
            )
        run = _batched_extractor(imgs.shape[1], imgs.shape[2], self.batch,
                                 self.extractor.params,
                                 _dist_tuple(self.camera))
        outs = run(imgs, np.float32(self.extractor.params.ini_th_fast),
                   np.float32(self.extractor.params.min_th_fast))
        bows = [None] * (hi - lo)
        if self.vocab is not None:
            # queue one descent per frame (async), fetch the whole batch
            # in one bundled round trip — per-frame Vocabulary.transform
            # blocks on its own fetch every frame
            import jax

            dev = [self.vocab.descend(outs[k]["desc"], outs[k]["valid"])
                   for k in range(hi - lo)]
            bows = [self.vocab.assemble(leaf, nid)
                    for leaf, nid in jax.device_get(dev)]
        for k in range(hi - lo):
            self._cache[lo + k] = (outs[k], bows[k])

    def frame(self, i: int) -> Frame:
        lo = i - (i % self.batch)
        if i not in self._cache:
            self._dispatch(lo)
        self._dispatch(lo + self.batch)    # eager look-ahead
        out, bow_nid = self._cache.pop(i)
        return Frame.from_extracted(i, out, self.camera, vocab=self.vocab,
                                    bow_nid=bow_nid)

    def __len__(self) -> int:
        return len(self.images)

    def __iter__(self):
        for i in range(len(self.images)):
            yield self.frame(i)
