"""Frame — per-image feature bundle (fixed-capacity arrays + mask).

Parity with src/Frame.{hpp,cpp}: keypoints, undistorted keypoints,
descriptors, spatial grid assignment, and (when a vocabulary is attached)
BoW vectors.  The reference's ctor pipeline `findFeatures ->
undistortKeypoints -> assignFeaturesToGrid -> computeBoW`
(src/Frame.hpp:54-64) runs here as: extractor call (compiled pyramid
program) -> vectorised undistortion -> cell ids -> optional vocab
transform.  `getFeaturesInArea` (src/Frame.cpp:201-260) has no grid walk:
radius queries are masked comparisons over the padded arrays, done inside
the matching kernels instead.

Transfer discipline: feature arrays live on DEVICE (that is where the
matchers/geometry consume them); host mirrors are materialised lazily, in
ONE bundled `jax.device_get`, the first time host code touches any of
them.  Each device↔host transfer blocks the host on the device, so the
rule is: never fetch per-array, never re-upload what the device already
has.
"""

from __future__ import annotations

import numpy as np

from irotavg_tpu.frontend.camera import Camera

# feature arrays, in extractor-output order
_FIELDS = ("x", "y", "octave", "angle", "response", "size", "desc", "valid")
_LAZY = _FIELDS + ("xu", "yu")
_DEV_F32 = ("xu", "yu", "angle")


class Frame:
    """Feature bundle for one image.

    Attributes (N = extractor capacity, masked by ``valid``):
      x, y:        level-0 keypoint coords (px, distorted/original)
      xu, yu:      undistorted coords (== x, y when k1 == 0)
      octave:      pyramid level per keypoint
      angle:       orientation (radians)
      response:    corner score
      size:        scaled patch diameter
      desc:        (N, 8) uint32 BRIEF-256 words (or (N, 128) f32 SIFT)
      valid:       (N,) bool
      cell:        (N, 2) int32 undistorted-grid (col, row), -1 outside

    All of the above are lazy host mirrors of the device arrays; use
    :meth:`dev` for the device copies and :attr:`capacity` for N (neither
    touches the interconnect).  ``bow``/``feat_nodes`` are filled by
    :meth:`compute_bow`.
    """

    def __init__(self, frame_id: int, image, extractor, camera: Camera,
                 vocab=None, keep_image: bool = False):
        self.id = frame_id
        # The reference Frame retains the image (Frame::getImage,
        # src/Frame.cpp:141-160) for the GUI match plots; here retention is
        # opt-in (utils/viz.plot_matches) to keep memory flat.
        self.image = np.asarray(image) if keep_image else None
        self.camera = camera
        self._attach(extractor(image), camera, vocab)

    @classmethod
    def from_extracted(cls, frame_id: int, out: dict, camera: Camera,
                       vocab=None, bow_nid=None) -> "Frame":
        """Build a Frame from an extractor output dict already on device
        (the batched look-ahead path, frontend/prefetch.py) — same
        attribute contract as the constructor, no extraction dispatch.

        ``bow_nid``: precomputed ``(bow, feat_nodes)`` from a batched
        vocabulary descent; when given, ``vocab`` is not consulted (the
        per-frame transform would cost a blocking device fetch)."""
        self = cls.__new__(cls)
        self.id = frame_id
        self.image = None
        self.camera = camera
        self._attach(out, camera, None if bow_nid is not None else vocab)
        if bow_nid is not None:
            self.bow, self.feat_nodes = bow_nid
        return self

    def _attach(self, out: dict, camera: Camera, vocab) -> None:
        self._device = {
            "x": out["x0"], "y": out["y0"], "octave": out["octave"],
            "angle": out["angle"], "response": out["response"],
            "size": out["size"], "desc": out["desc"], "valid": out["valid"],
        }
        self._host: dict | None = None
        self._pm1_cache = None
        self.bow = None          # (word_id -> weight) dict, L1-normalised
        self.feat_nodes = None   # (N,) int32 vocab node id at levelsup

        if "xu" in out:
            # the batched extractor already undistorted in-program
            # (frontend/prefetch.py:_undistort_xla) — no extra transfers
            self._device["xu"] = out["xu"]
            self._device["yu"] = out["yu"]
        elif camera.has_distortion:
            # direct-construction fallback: undistortion as host math; it
            # forces the one bundled fetch, and the results are
            # re-uploaded once for the device matchers
            import jax.numpy as jnp

            h = self._fetch_host()
            xu, yu = camera.undistort_points(h["x"], h["y"])
            h["xu"], h["yu"] = xu, yu
            self._device["xu"] = jnp.asarray(xu, jnp.float32)
            self._device["yu"] = jnp.asarray(yu, jnp.float32)
        else:
            self._device["xu"] = self._device["x"]
            self._device["yu"] = self._device["y"]

        if vocab is not None:
            self.compute_bow(vocab)

    @classmethod
    def restore(cls, frame_id: int, camera: Camera, arrays: dict,
                bow=None, feat_nodes=None) -> "Frame":
        """Rebuild a Frame from checkpointed arrays without re-extraction.

        ``arrays`` must hold x, y, xu, yu, octave, angle, response, size,
        desc, valid, cell (the attribute layout documented above).
        """
        self = cls.__new__(cls)
        self.id = frame_id
        self.camera = camera
        self.image = None
        self._device = {}
        self._host = {k: np.asarray(v) for k, v in arrays.items()}
        self._pm1_cache = None
        self.bow = bow
        self.feat_nodes = feat_nodes
        return self

    # -- transfer management --------------------------------------------------

    def _fetch_host(self) -> dict:
        """Materialise all host mirrors in one bundled transfer."""
        if self._host is None:
            import jax

            self._host = jax.device_get(self._device)
        return self._host

    def __getattr__(self, name: str):
        # only consulted when normal lookup fails: lazy host mirrors
        if name.startswith("_"):
            raise AttributeError(name)
        if name in _LAZY:
            h = self._fetch_host()
            if name in h:
                return h[name]
            if name in ("xu", "yu"):           # k1 == 0: xu/yu alias x/y
                return h[name[0]]
        if name == "cell":
            cx, cy = self.camera.grid_cell(self.xu, self.yu)
            cell = np.stack([cx, cy], axis=1)
            self._fetch_host()["cell"] = cell
            return cell
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}"
        )

    @property
    def capacity(self) -> int:
        """Feature-slot count N (shape only — no transfer)."""
        src = self._device if self._device else self._host
        return int(src["valid"].shape[0])

    def dev(self, name: str):
        """Device-resident copy of a feature array, cached per frame."""
        arr = self._device.get(name)
        if arr is None:
            import jax.numpy as jnp

            v = getattr(self, name)
            arr = jnp.asarray(
                v, jnp.float32 if name in _DEV_F32 else None
            )
            self._device[name] = arr
        return arr

    @property
    def pm1(self):
        """(N, 256) ±1 bfloat16 descriptor-bit expansion, cached — the
        matrix-product form of the 256-bit BRIEF descriptor (see
        ops/hamming.py)."""
        if self._pm1_cache is None:
            from irotavg_tpu.ops.hamming import unpack_pm1

            self._pm1_cache = unpack_pm1(self.dev("desc"))
        return self._pm1_cache

    @property
    def n_valid(self) -> int:
        return int(np.asarray(self.valid).sum())

    def compute_bow(self, vocab, levelsup: int = 4) -> None:
        """Vocabulary transform (src/Frame.cpp:263-274, ORB_VOCAB_LEVELS=4)."""
        self.bow, self.feat_nodes = vocab.transform(
            self.dev("desc"), self.dev("valid"), levelsup=levelsup
        )
        self._device.pop("feat_nodes", None)  # drop stale dev cache
