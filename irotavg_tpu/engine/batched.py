"""Batched window solver — many independent rotAvg windows per dispatch.

The incremental product shape is thousands of small solves: every accepted
keyframe triggers ``rotAvg(10)`` (src/IRotAvg.cpp:371-378), a ~16-node /
~40-edge problem.  One such window cannot fill the device — the n^2 Cholesky
at n=32 is latency-bound — but a *batch* of them can: `vmap` over the
window axis turns the per-window Cholesky into one batched
(W, n_pad, n_pad) factorisation and every elementwise stage into (W, m)
tensors, so serving many sequences at once (the multi-camera / fleet
deployment shape) costs barely more than serving one.

Windows inside one sequence are sequentially dependent (each warm-starts
from the previous write-back, src/ViewGraph.cpp:1396-1397), so the batch
axis is *across independent sequences/problems*, not across time.

The convergence loops stay per-window semantically: `vmap` of
`lax.while_loop` runs until the slowest window converges, with converged
windows masked (XLA lowers the batched loop to a single program); each
window still reports its own iteration count.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from irotavg_tpu import so3
from irotavg_tpu.solver.graph import RotationGraph
from irotavg_tpu.solver.irls import Cost, IRLSConfig, irls
from irotavg_tpu.solver.l1ra import L1RAConfig, l1ra


@lru_cache(maxsize=None)
def batched_window_solver(m_pad: int, n_pad: int, l1_iters: int = 100,
                          irls_iters: int = 100,
                          sigma: float = float(5.0 * np.pi / 180.0),
                          change_th: float = 1e-3,
                          cost_name: str = "Geman-McClure",
                          dtype_name: str = "float32"):
    """Compiled vmapped L1-RA + IRLS pipeline for one padding bucket.

    Returns ``solve(edges (W,m,2), QQ (W,m,4), Q (W,n,4), f (W,),
    edge_mask (W,m), node_mask (W,n)) -> (Q (W,n,4), w (W,m),
    iters (W,), score (W,))`` — the same per-window contract as
    ``engine.incremental._window_solver`` with a leading window axis.
    """
    l1_cfg = L1RAConfig(max_iters=l1_iters, change_th=change_th)
    irls_cfg = IRLSConfig(
        cost=Cost.parse(cost_name), sigma=sigma, max_iters=irls_iters,
        change_th=change_th, backend="dense",
    )

    def one(edges, QQ, Q, f, edge_mask, node_mask):
        g = RotationGraph(edges=edges, QQ=QQ, Q=Q, f=f,
                          edge_mask=edge_mask, node_mask=node_mask)
        Q1, _, _ = l1ra(g, l1_cfg)
        Q2, w, iters, score = irls(dataclasses.replace(g, Q=Q1), irls_cfg)
        return so3.qnormalize(Q2), w, iters, score

    return jax.jit(jax.vmap(one))


def pack_windows(problems, m_pad: int | None = None, n_pad: int | None = None,
                 dtype=np.float32):
    """Stack a list of ``(edges, QQ, Q0, f)`` problems into padded batch
    arrays for :func:`batched_window_solver`.

    Padded edges point at node 0 with identity relative rotation and are
    masked out; padded nodes are identity quaternions outside
    ``node_mask`` (same padding contract as ``RotationGraph.pad_to``).
    """
    W = len(problems)
    if m_pad is None:
        m_pad = max(len(e) for e, _, _, _ in problems)
    if n_pad is None:
        n_pad = max(len(q) for _, _, q, _ in problems)
    edges = np.zeros((W, m_pad, 2), np.int32)
    QQ = np.zeros((W, m_pad, 4), dtype)
    QQ[..., 3] = 1.0
    Q = np.zeros((W, n_pad, 4), dtype)
    Q[..., 3] = 1.0
    f = np.zeros((W,), np.int32)
    emask = np.zeros((W, m_pad), bool)
    nmask = np.zeros((W, n_pad), bool)
    for k, (e, qq, q0, fk) in enumerate(problems):
        m, n = len(e), len(q0)
        if m > m_pad or n > n_pad:
            raise ValueError(f"window {k} ({m}, {n}) exceeds padding "
                             f"({m_pad}, {n_pad})")
        edges[k, :m] = e
        QQ[k, :m] = qq
        Q[k, :n] = q0
        f[k] = fk
        emask[k, :m] = True
        nmask[k, :n] = True
    return edges, QQ, Q, f, emask, nmask


def solve_windows(problems, *, l1_iters: int = 100, irls_iters: int = 100,
                  sigma: float = float(5.0 * np.pi / 180.0),
                  change_th: float = 1e-3, cost: str = "Geman-McClure",
                  dtype=np.float32, m_pad: int | None = None,
                  n_pad: int | None = None):
    """Solve a list of independent ``(edges, QQ, Q0, f)`` windows in ONE
    device dispatch.  Returns ``(Q_list, w_list, iters (W,), score (W,))``
    with per-window arrays trimmed back to their true sizes.
    """
    packed = pack_windows(problems, m_pad, n_pad, dtype)
    solve = batched_window_solver(
        packed[0].shape[1], packed[2].shape[1], l1_iters, irls_iters,
        float(sigma), float(change_th), cost, np.dtype(dtype).name,
    )
    Qf, w, iters, score = jax.device_get(
        solve(*(jnp.asarray(a) for a in packed))
    )
    Q_list = [Qf[k, : len(q0)] for k, (_, _, q0, _) in enumerate(problems)]
    w_list = [w[k, : len(e)] for k, (e, _, _, _) in enumerate(problems)]
    return Q_list, w_list, iters, score
