"""Incremental windowed rotation averaging over a growing view graph.

Behavioural contract (src/ViewGraph.cpp:1263-1435, `ViewGraph::rotAvg`):

* ``win_size = min(num_views, win_size)``; return if < 2.
* Collect every edge whose larger endpoint is one of the last ``win_size``
  views (the reference iterates window views and keeps connections with
  ``i < j``; since ``j`` ranges over the window, this is exactly
  max(i,j) >= m - win_size).
* Skip the solve if the number of collected edges or incident vertices is
  below ``win_size``.
* Reindex incident vertices in ascending order so that all *fixed* ones
  come first: fixed = outside the window, or explicitly pinned via
  :meth:`IncrementalRotAvg.fix_pose`.  ``f`` = fixed count; if ``f == 0``
  the first row is overwritten with the identity and ``f = 1``.
* Warm start from current estimates (no spanning-tree re-init), run L1-RA
  (100 iters) then IRLS (Geman-McClure, sigma 5 deg, 100 iters, th 1e-3),
  write back normalised rotations for the non-fixed vertices.

Design: the gather/reindex bookkeeping is O(window) host work; the
solve runs as one jitted L1-RA+IRLS pipeline per (edge, vertex) size
bucket, so a long sequence reuses a handful of compiled executables.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import jax
import numpy as np

from irotavg_tpu import so3
from irotavg_tpu.solver.graph import RotationGraph
from irotavg_tpu.solver.irls import Cost, IRLSConfig, irls
from irotavg_tpu.solver.l1ra import L1RAConfig, l1ra


def _bucket(x: int, lo: int = 32) -> int:
    """Next power-of-two bucket (>= lo) for shape-stable compilation."""
    b = lo
    while b < x:
        b <<= 1
    return b


@lru_cache(maxsize=None)
def _window_solver(m_pad: int, n_pad: int, l1_iters: int, irls_iters: int,
                   sigma: float, change_th: float, cost_name: str,
                   dtype_name: str, backend: str = "dense"):
    """Compiled L1-RA + IRLS pipeline for one padding bucket.

    ``backend="dense"`` factorises the n^2 Laplacian densely (right for
    windowed solves); ``"cg"`` is the matrix-free escape hatch for the
    quasi-global re-solve (src/IRotAvg.cpp:371-378 calls rotAvg(5e6) after
    loop closure), where a dense n^2 build would be O(n^2) HBM.
    """
    cg_tol = 1e-7 if dtype_name == "float32" else 1e-10
    l1_cfg = L1RAConfig(max_iters=l1_iters, change_th=change_th,
                        backend=backend, cg_tol=cg_tol)
    irls_cfg = IRLSConfig(
        cost=Cost.parse(cost_name),
        sigma=sigma,
        max_iters=irls_iters,
        change_th=change_th,
        backend=backend,
        cg_tol=cg_tol,
    )

    @jax.jit
    def solve(edges, QQ, Q, f, edge_mask, node_mask):
        g = RotationGraph(
            edges=edges, QQ=QQ, Q=Q, f=f,
            edge_mask=edge_mask, node_mask=node_mask,
        )
        Q1, _, _ = l1ra(g, l1_cfg)
        Q2, w, iters, score = irls(dataclasses.replace(g, Q=Q1), irls_cfg)
        return so3.qnormalize(Q2), w, iters, score

    return solve


class IncrementalRotAvg:
    """Growing view-graph solver state (absolute rotations + edge list).

    This is the optimisation half of the reference's ``ViewGraph``: views
    and relative-rotation edges are appended as the front-end accepts
    keyframes, and :meth:`rot_avg` refines the last-window rotations.
    Quaternions are ``[x y z w]`` rows, convention ``R_j = R_ij R_i``.
    """

    def __init__(self, dtype=np.float64, dense_n_max: int = 2048,
                 large_dtype=np.float32):
        """``dense_n_max``: largest node bucket solved with a dense
        Cholesky; bigger windows (the quasi-global re-solve) switch to
        matrix-free Jacobi-CG.  ``large_dtype`` (None to disable) is the
        compute dtype for those large solves."""
        self.dtype = np.dtype(dtype)
        self.dense_n_max = int(dense_n_max)
        self.large_dtype = None if large_dtype is None else np.dtype(large_dtype)
        self._Q = np.zeros((0, 4), self.dtype)  # absolute rotations
        self.fixed = np.zeros((0,), bool)      # explicit fix_pose pins
        self.edges = np.zeros((0, 2), np.int32)
        self.QQ = np.zeros((0, 4), np.dtype(dtype))
        # per-node adjacency for the window gather: edge ids by larger endpoint
        self._edges_by_max: list[list[int]] = []
        # one in-flight lazy solve: (order, f, n, device result)
        self._pending = None

    # -- lazy write-back ------------------------------------------------------

    def _resolve(self) -> None:
        """Block on the in-flight lazy solve (if any) and write it back."""
        if self._pending is None:
            return
        order, f, n, res = self._pending
        self._pending = None
        Q_out, w, iters, score = jax.device_get(res)
        self._Q[order[f:]] = Q_out[f:n]

    @property
    def Q(self) -> np.ndarray:
        """Absolute rotations; resolves any in-flight lazy solve first."""
        self._resolve()
        return self._Q

    @Q.setter
    def Q(self, value) -> None:
        # Wholesale assignment supersedes any in-flight lazy solve: the
        # new state is authoritative (the checkpoint-restore path), so the
        # pending result is deliberately discarded, not resolved into it.
        self.discard_pending()
        self._Q = value

    def discard_pending(self) -> None:
        """Drop an in-flight lazy solve without writing it back."""
        self._pending = None

    # -- graph construction -------------------------------------------------

    @property
    def num_views(self) -> int:
        return self._Q.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    def add_view(self, q=None) -> int:
        """Append a view; returns its index.  ``q`` defaults to identity
        (the reference's `View::m_pose` default, src/Pose.hpp:43)."""
        if q is None:
            q = np.array([0.0, 0.0, 0.0, 1.0], self.dtype)
        self.Q = np.concatenate([self.Q, np.asarray(q, self.dtype)[None]])
        self.fixed = np.concatenate([self.fixed, [False]])
        self._edges_by_max.append([])
        return self.num_views - 1

    def add_edge(self, i: int, j: int, q_rel) -> int:
        """Append relative rotation ``R_j = R_ij R_i`` for ``i < j``."""
        if not (0 <= i < j < self.num_views):
            raise ValueError(f"bad edge ({i}, {j}) for {self.num_views} views")
        self.edges = np.concatenate(
            [self.edges, np.array([[i, j]], np.int32)]
        )
        self.QQ = np.concatenate(
            [self.QQ, np.asarray(q_rel, self.dtype)[None]]
        )
        eid = self.num_edges - 1
        self._edges_by_max[j].append(eid)
        return eid

    def fix_pose(self, idx: int, q=None) -> None:
        """Pin view ``idx``; optionally overwrite its rotation (the GT
        anchoring hook, src/ViewGraph.cpp:1234-1245)."""
        self.fixed[idx] = True
        if q is not None:
            self.Q[idx] = np.asarray(q, self.dtype)

    # -- the windowed solve --------------------------------------------------

    def rot_avg(
        self,
        win_size: int,
        *,
        l1_iters: int = 100,
        irls_iters: int = 100,
        sigma: float = float(5.0 * np.pi / 180.0),
        change_th: float = 1e-3,
        cost: str = "Geman-McClure",
        lazy: bool = False,
    ) -> dict | None:
        """Solve the window subproblem and write back rotations in place.

        Returns a stats dict, or None if the solve was skipped (too few
        edges/vertices — src/ViewGraph.cpp:1313-1321).

        ``lazy=True`` dispatches the solve and returns immediately; the
        write-back happens at the next access of :attr:`Q` (or the next
        ``rot_avg``/``fix_pose``/``save_poses``).  The per-keyframe solve
        then overlaps the next frame's extraction and matching instead
        of blocking the host on the fetch every keyframe.  The lazy stats dict
        carries the shape/bucket fields only (device-side results are
        not yet known).
        """
        m_views = self.num_views
        win_size = min(m_views, win_size)
        if win_size < 2:
            return None

        lo = m_views - win_size
        edge_ids = [e for j in range(lo, m_views) for e in self._edges_by_max[j]]
        if len(edge_ids) < win_size:
            return None
        sub_edges = self.edges[edge_ids]
        verts = np.unique(sub_edges)
        if len(verts) < win_size:
            return None

        # ascending vertex order; fixed (out-of-window or pinned) first
        vfixed = (verts < lo) | self.fixed[verts]
        order = np.concatenate([verts[vfixed], verts[~vfixed]])
        f = int(vfixed.sum())
        new_idx = np.empty(self.num_views, np.int64)
        new_idx[order] = np.arange(len(order))

        Q_sub = self.Q[order].copy()
        if f == 0:
            Q_sub[0] = (0.0, 0.0, 0.0, 1.0)
            f = 1
        edges_sub = new_idx[sub_edges].astype(np.int32)
        QQ_sub = self.QQ[edge_ids]

        m, n = len(edge_ids), len(order)
        m_pad, n_pad = _bucket(m), _bucket(n)
        large = n_pad > self.dense_n_max
        backend = "cg" if large else "dense"
        sdtype = (self.large_dtype
                  if (large and self.large_dtype is not None) else self.dtype)
        edges_p = np.zeros((m_pad, 2), np.int32)
        edges_p[:m] = edges_sub
        QQ_p = np.zeros((m_pad, 4), sdtype)
        QQ_p[:, 3] = 1.0
        QQ_p[:m] = QQ_sub
        Q_p = np.zeros((n_pad, 4), sdtype)
        Q_p[:, 3] = 1.0
        Q_p[:n] = Q_sub
        emask = np.zeros(m_pad, bool)
        emask[:m] = True
        nmask = np.zeros(n_pad, bool)
        nmask[:n] = True

        solve = _window_solver(
            m_pad, n_pad, l1_iters, irls_iters, float(sigma),
            float(change_th), cost, np.dtype(sdtype).name, backend,
        )
        # numpy inputs go straight to the jitted call: the transfers ride
        # the dispatch; explicit per-array `jnp.asarray` would be one
        # device op each
        res = solve(edges_p, QQ_p, Q_p, np.int32(f), emask, nmask)
        stats = {
            "m": m,
            "n": n,
            "f": f,
            "m_pad": m_pad,
            "n_pad": n_pad,
            "backend": backend,
            "solve_dtype": np.dtype(sdtype).name,
            "solved_views": order[f:],
        }
        if lazy:
            # start the device->host transfer now, in the background: by
            # the time the next keyframe resolves this solve, the bytes
            # are already host-side and device_get is a local copy rather
            # than a blocking transfer
            for a in res:
                try:
                    a.copy_to_host_async()
                except AttributeError:  # non-array leaf / older jax
                    pass
            self._pending = (order, f, n, res)
            stats["lazy"] = True
            return stats

        Q_out, w, iters, score = jax.device_get(res)  # one bundled fetch
        self._Q[order[f:]] = Q_out[f:n]
        stats.update(
            irls_iters=int(iters), score=float(score), weights=w[:m]
        )
        return stats

    # -- persistence ---------------------------------------------------------

    def save_poses(self, path: str) -> None:
        """Write per view ``id<TAB>qw qx qy qz tx ty tz`` rows.

        Format parity with `ViewGraph::savePoses`
        (src/ViewGraph.cpp:1206-1231): tab-separated, 17-digit scientific
        floats, zero translations (rotations-only is the paper's thesis).
        """
        with open(path, "w") as fh:
            for i in range(self.num_views):
                x, y, z, w = self.Q[i]
                vals = (w, x, y, z, 0.0, 0.0, 0.0)
                fh.write(
                    str(i) + "\t" + "\t".join(f"{v:.17e}" for v in vals) + "\n"
                )
