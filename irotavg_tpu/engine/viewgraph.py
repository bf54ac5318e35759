"""The SLAM view-graph engine: frame ingestion, connection, loop closure.

Orchestration parity with `ViewGraph` (src/ViewGraph.cpp):

* `process_frame` (:1035-1145): adaptive local search against the previous
  view (`findInitialPose`, :828-902) with the keyframe gate
  ``local_rad < 5 px -> reject``; epipolar refinement; hard failure when
  the frame cannot be connected with >= min_matches; then pivot-chained
  connections back through the view window (`findPose`, :786-825).
* loop closure: min-BoW-score floor over covisible neighbours
  (:906-944), database cascade (ViewDatabase), consecutive-group
  consistency check (:948-1033, default threshold 7).
* `rot_avg`: delegates to the incremental windowed solver
  (engine/incremental.py), feeding edges from the connection store.

Where the reference calls std::exit on unrecoverable states
(:1083-1087, :1138-1142) this engine raises :class:`FrameConnectionError`
so applications can decide.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from irotavg_tpu import so3
from irotavg_tpu.engine.incremental import IncrementalRotAvg
from irotavg_tpu.geometry.twoview import RelativePose
from irotavg_tpu.matching.matchers import matches_to_pairs
from irotavg_tpu.placerec.bow import bow_score
from irotavg_tpu.placerec.database import ViewDatabase


class FrameConnectionError(RuntimeError):
    """Raised where the reference exits: a frame could not be connected."""


@dataclasses.dataclass
class Connection:
    pairs: np.ndarray        # (M, 2) feature indices (i-side, j-side), i < j
    pose: RelativePose       # x_j ~ R x_i + t


class ViewGraph:
    """Incremental monocular rotation-averaging SLAM engine."""

    COVISIBILITY_CONSISTENCY_TH = 7  # src/ViewGraph.hpp:99

    def __init__(self, camera, *, min_matches: int = 100):
        self.camera = camera
        self.min_matches = min_matches
        self.frames: list = []            # accepted keyframes (Frame)
        self.connections: dict[tuple[int, int], Connection] = {}
        self.adjacency: dict[int, dict[int, int]] = {}
        self.ra = IncrementalRotAvg()
        self.local_rad = 45.0             # src/ViewGraph.hpp:134
        self.db = ViewDatabase()
        self._consistent_groups: list[tuple[set, int]] = []
        self._dev_consts = None           # camera constants, uploaded once

    def _consts(self) -> dict:
        """Device-resident per-camera constants, uploaded once.

        Rebuilding these per frame (`jnp.asarray`, `jnp.float32`) would be
        one host-to-device dispatch each, every frame."""
        if self._dev_consts is None:
            import jax.numpy as jnp

            cam = self.camera
            self._dev_consts = {
                "camv": jnp.asarray(
                    [cam.fx, cam.fy, cam.cx, cam.cy], jnp.float32),
                "th_norm": jnp.asarray(1.0 / cam.fx, jnp.float32),
                "K_inv": jnp.asarray(
                    np.linalg.inv(cam.K), jnp.float32),
                "sigma2": jnp.asarray(
                    (1.2 ** np.arange(8)) ** 2, jnp.float32),
            }
        return self._dev_consts

    # -- graph bookkeeping ---------------------------------------------------

    @property
    def num_views(self) -> int:
        return len(self.frames)

    def connect(self, i: int, j: int, pairs: np.ndarray,
                rel: RelativePose) -> None:
        if i > j:
            raise ValueError("connect expects i < j")
        self.connections[(i, j)] = Connection(pairs=pairs, pose=rel)
        self.adjacency.setdefault(i, {})[j] = len(pairs)
        self.adjacency.setdefault(j, {})[i] = len(pairs)
        self.ra.add_edge(i, j, rel.q)

    def is_connected(self, i: int, j: int) -> bool:
        return (min(i, j), max(i, j)) in self.connections

    def best_covisibility(self, i: int, n: int) -> list[int]:
        """Top-n neighbours by match count (View::getBestCovisibilityViews,
        src/View.hpp:98-136)."""
        nb = self.adjacency.get(i, {})
        return [v for v, _ in sorted(nb.items(), key=lambda x: -x[1])[:n]]

    # -- frame ingestion -----------------------------------------------------

    def process_frame(self, frame, win_size: int = 4) -> bool:
        """Ingest a frame; returns False when rejected (not a keyframe).

        ONE device program + ONE bundled fetch per frame
        (src/ViewGraph.cpp:1035-1145): `fused_process_frame` runs the
        adaptive initial pose, decides the 5 px keyframe gate on device
        (``lax.cond`` — rejected frames skip the refine/window compute),
        and for accepted frames runs the epipolar refine + pivot-chained
        window walk.  Host keeps only the decisions: the gate, connect
        bookkeeping, and the stop-at-first-failure window walk.
        """
        import jax

        from irotavg_tpu.geometry.fused import fused_process_frame

        if self.num_views == 0:
            self.frames.append(frame)
            self.ra.add_view()
            return True

        curr_idx = self.num_views
        prev_idx = curr_idx - 1
        prev = self.frames[prev_idx]
        n = frame.capacity
        assert prev.capacity == n, "mixed frame capacities"
        c = self._consts()

        # window candidates, padded to a fixed K so every fill level
        # shares one executable (padded slots repeat candidate 0, inactive)
        cand_ids = [v1 for v1 in range(prev_idx - 1, -1, -1)
                    if (curr_idx - v1) <= win_size]
        k_pad = max(win_size - 1, 1)
        m12_w2p = np.full((k_pad, n), -1, np.int32)
        active = np.zeros(k_pad, bool)
        fr = []
        for ki in range(k_pad):
            v1 = cand_ids[ki] if ki < len(cand_ids) else (
                cand_ids[0] if cand_ids else prev_idx)
            assert self.frames[v1].capacity == n, (
                f"mixed frame capacities: window candidate {v1} has "
                f"{self.frames[v1].capacity}, current frame has {n}")
            fr.append(self.frames[v1])
            if ki >= len(cand_ids):
                continue
            key = (min(v1, prev_idx), max(v1, prev_idx))
            conn = self.connections.get(key)
            if conn is None:
                continue
            p = conn.pairs if key[0] == v1 else conn.pairs[:, ::-1]
            m12_w2p[ki, p[:, 0]] = p[:, 1]
            active[ki] = len(p) > 0

        has_nodes = (frame.feat_nodes is not None
                     and prev.feat_nodes is not None
                     and all(f.feat_nodes is not None for f in fr))

        def nodes(f):
            return f.dev("feat_nodes") if has_nodes else None

        local_rad, rel_valid, refined, window = jax.device_get(
            fused_process_frame(
                frame.pm1, nodes(frame), frame.dev("valid"),
                frame.dev("angle"), frame.dev("xu"), frame.dev("yu"),
                frame.dev("octave"),
                prev.pm1, nodes(prev), prev.dev("valid"),
                prev.dev("angle"), prev.dev("xu"), prev.dev("yu"),
                prev.dev("octave"),
                tuple(
                    (f.pm1, nodes(f), f.dev("valid"), f.dev("angle"),
                     f.dev("xu"), f.dev("yu"), f.dev("octave"))
                    for f in fr
                ),
                m12_w2p, active,
                np.float32(self.local_rad),
                c["K_inv"], c["sigma2"], c["camv"], c["th_norm"],
                np.uint32(self.num_views),
                np.int32(self.min_matches),
                np.int32(2 * self.min_matches), np.float32(0.9),
                has_nodes=has_nodes,
            )
        )
        self.local_rad = float(local_rad)
        if self.local_rad < 5.0:
            return False                       # keyframe gate (:1071-1074)
        E_r, R_r, t_r, n_r, m12_pc = refined
        E_w, R_w, t_w, n_w, m12_w, succ_w = window

        self.frames.append(frame)
        self.ra.add_view()

        rows = np.where(m12_pc >= 0)[0]
        pairs = np.stack([rows, m12_pc[rows]], axis=1).astype(np.int32)
        if not bool(rel_valid) or len(pairs) < self.min_matches:
            raise FrameConnectionError(
                f"failed to connect frame {curr_idx}: insufficient matches "
                f"{len(pairs)}"
            )
        rel = RelativePose(
            R=np.asarray(R_r, np.float64), t=np.asarray(t_r, np.float64),
            E=np.asarray(E_r, np.float64), n_cheirality=int(n_r),
            inlier_mask=np.ones(len(pairs), bool),
        )
        self.connect(prev_idx, curr_idx, pairs, rel)
        # warm-start the new rotation: R_curr = R_rel @ R_prev
        self.ra.Q[curr_idx] = so3.qmul(rel.q, self.ra.Q[prev_idx])

        # window walk: stop at the first failure like the reference's
        # sequential loop (src/ViewGraph.cpp:1109-1136)
        for ki, v1 in enumerate(cand_ids):
            if not bool(succ_w[ki]):
                break
            rows_w = np.where(m12_w[ki] >= 0)[0]
            pairs_w = np.stack(
                [rows_w, m12_w[ki][rows_w]], axis=1
            ).astype(np.int32)
            rel_w = RelativePose(
                R=np.asarray(R_w[ki], np.float64),
                t=np.asarray(t_w[ki], np.float64),
                E=np.asarray(E_w[ki], np.float64),
                n_cheirality=int(n_w[ki]),
                inlier_mask=np.ones(len(pairs_w), bool),
            )
            self.connect(v1, curr_idx, pairs_w, rel_w)
        return True

    # -- loop closure --------------------------------------------------------

    def detect_loop_candidates(self, view_id: int) -> list[int]:
        """Min-score floor over connected views, then the database cascade
        (:906-944)."""
        frame = self.frames[view_id]
        if frame.bow is None:
            return []
        min_score = 1.0
        for nb in self.adjacency.get(view_id, {}):
            nb_bow = self.frames[nb].bow
            if nb_bow is not None:
                min_score = min(min_score, bow_score(frame.bow, nb_bow))
        return self.db.detect_loop_candidates(
            query_id=view_id,
            bow=frame.bow,
            connected=set(self.adjacency.get(view_id, {})),
            min_score=min_score,
            covisibility_fn=self.best_covisibility,
            score_fn=bow_score,
        )

    def check_loop_consistency(self, candidates: list[int]) -> list[int]:
        """Consecutive-keyframe group consistency (:948-1033)."""
        consistent: list[int] = []
        new_groups: list[tuple[set, int]] = []
        prev_flag = [False] * len(self._consistent_groups)
        for cand in candidates:
            group = set(self.adjacency.get(cand, {})) | {cand}
            some = False
            enough = False
            for g, (pg, cnt) in enumerate(self._consistent_groups):
                if group & pg:
                    some = True
                    cur = cnt + 1
                    if not prev_flag[g]:
                        new_groups.append((group, cur))
                        prev_flag[g] = True
                    if cur >= self.COVISIBILITY_CONSISTENCY_TH and not enough:
                        consistent.append(cand)
                        enough = True
            if not some:
                new_groups.append((group, 0))
        self._consistent_groups = new_groups
        return consistent

    def close_loop(self, view_id: int, cand_id: int, *,
                   min_matches: int = 150) -> bool:
        """BoW match + relative pose + refine + connect (the loop-closure
        block of the app, src/IRotAvg.cpp:309-347) — the device work runs
        as ONE program (`geometry/fused.py:fused_bow_pair_estimate`),
        one dispatch + one bundled fetch per candidate."""
        import jax

        from irotavg_tpu.geometry.fused import fused_bow_pair_estimate

        f2 = self.frames[view_id]
        f1 = self.frames[cand_id]
        c = self._consts()
        has_nodes = (f1.feat_nodes is not None
                     and f2.feat_nodes is not None)

        def nodes(f):
            return f.dev("feat_nodes") if has_nodes else None

        E, R, t, n_che, m12, success = jax.device_get(
            fused_bow_pair_estimate(
                f1.pm1, nodes(f1), f1.dev("valid"), f1.dev("angle"),
                f1.dev("xu"), f1.dev("yu"), f1.dev("octave"),
                f2.pm1.T, nodes(f2), f2.dev("valid"), f2.dev("angle"),
                f2.dev("xu"), f2.dev("yu"),
                c["K_inv"], c["sigma2"], c["camv"], c["th_norm"],
                np.uint32((view_id * 31 + cand_id) & 0xFFFFFFFF),
                np.float32(0.9), np.int32(min_matches),
                has_nodes=has_nodes,
            )
        )
        if not bool(success):
            return False
        pairs = matches_to_pairs(m12)
        rel = RelativePose(
            R=np.asarray(R, np.float64), t=np.asarray(t, np.float64),
            E=np.asarray(E, np.float64), n_cheirality=int(n_che),
            inlier_mask=np.ones(len(pairs), bool),
        )
        self.connect(cand_id, view_id, pairs, rel)
        return True

    def add_to_database(self, view_id: int) -> None:
        bow = self.frames[view_id].bow
        if bow is not None:
            self.db.add(view_id, bow)

    # -- solver bridge / persistence ----------------------------------------

    def rot_avg(self, win_size: int, **kw):
        # lazy by default in the engine: the windowed solve's write-back
        # overlaps the next frame's extraction/matching (it resolves at
        # the next ra.Q access).  Pass lazy=False for the synchronous
        # stats (iteration counts, weights).
        kw.setdefault("lazy", True)
        return self.ra.rot_avg(win_size, **kw)

    def fix_pose(self, idx: int, q=None) -> None:
        self.ra.fix_pose(idx, q)

    def save_poses(self, path: str) -> None:
        self.ra.save_poses(path)

    def save_view_graph(self, path: str) -> None:
        """Serialise every connection's relative pose to YAML —
        `ViewGraph::saveViewGraph` (src/ViewGraph.cpp:1148-1171).

        The reference emits one ``i``/``j``/``R``/``t`` record per edge
        (i < j) through cv::FileStorage; the same records are written here
        as a proper YAML sequence under ``edges`` (the reference's repeated
        top-level keys are not parseable YAML, so the shape is rationalised
        — content is identical: frame ids, 3x3 R, 3-vector t).
        """
        lines = ["%YAML:1.0", "---", "edges:"]
        for (i, j), conn in sorted(self.connections.items()):
            R = np.asarray(conn.pose.R, np.float64).reshape(3, 3)
            t = np.asarray(conn.pose.t, np.float64).reshape(3)
            fi = self.frames[i].id
            fj = self.frames[j].id
            rdata = ", ".join(f"{v:.17e}" for v in R.ravel())
            tdata = ", ".join(f"{v:.17e}" for v in t)
            lines += [
                f"  - {{ i: {fi}, j: {fj},",
                f"      R: [ {rdata} ],",
                f"      t: [ {tdata} ] }}",
            ]
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")

    def save_pose_ids(self, path: str, frame_ids=None) -> None:
        """1-based original frame ids of accepted keyframes
        (src/IRotAvg.cpp:111-128)."""
        with open(path, "w") as fh:
            for f in self.frames:
                fh.write(f"{f.id + 1}\n")
