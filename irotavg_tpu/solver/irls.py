"""IRLS robust rotation averaging (array-native `irls`, ral/l1_irls.cpp:559-752).

Per outer iteration (all under one `jit`-compiled `lax.while_loop`):
  1. per-edge residual ``delta_rel`` -> tangent space via ``log_map``;
  2. solve the weighted least-squares ``min ||D (A W - w)||`` for the three
     tangent axes at once — as normal equations on the masked graph Laplacian
     ``A' D^2 A`` (dense batched Cholesky, or matrix-free Jacobi-CG);
  3. robust re-weighting from the post-solve residual ``E = A W - w`` using
     one of the 14 cost functions (formulas transcribed from the MATLAB
     comments at ral/l1_irls.cpp:617-727, including the clamping quirks);
  4. retraction ``Q <- Q * exp(W)`` (right multiplication, fixed rows get
     ``exp(0) = identity``);
  5. stop when the mean tangent-update norm over free nodes < ``change_th``.

The reference solves the weighted LS with SuiteSparseQR on ``D A``
(ral/l1_irls.cpp:536-556); normal equations halve the bits of precision, so
f32 callers should keep weights normalised (done internally) or use
float64 for golden comparisons.
"""

from __future__ import annotations

import dataclasses
import enum
from functools import partial

import jax
import jax.numpy as jnp

from irotavg_tpu import so3
from irotavg_tpu.solver.graph import (
    RotationGraph,
    incidence_matvec,
    incidence_rmatvec,
    laplacian_cg_solve,
    laplacian_cho_solve,
)


class Cost(enum.Enum):
    """Robust IRLS costs (ral/l1_irls.hpp:56-57)."""

    L2 = "L2"
    L1 = "L1"
    L15 = "L1.5"
    L05 = "L0.5"
    GEMAN_MCCLURE = "Geman-McClure"
    HUBER = "Huber"
    PSEUDO_HUBER = "Pseudo-Huber"
    ANDREWS = "Andrews"
    BISQUARE = "Bisquare"
    CAUCHY = "Cauchy"
    FAIR = "Fair"
    LOGISTIC = "Logistic"
    TALWAR = "Talwar"
    WELSCH = "Welsch"

    @staticmethod
    def parse(name: str) -> "Cost":
        for c in Cost:
            if c.value.lower() == name.lower():
                return c
        raise ValueError(f"Unknown cost: {name!r}")


def _safe_div(a, b):
    return a / jnp.where(b == 0, 1.0, b)


def update_weights(cost: Cost, E, prev_weights, sigma):
    """Vectorised robust weight update from residual rows ``E (m,3)``.

    Reproduces the exact clamps of ral/l1_irls.cpp:617-727, including:
      * Huber only overwrites weights where ``e >= 1`` (others keep their
        previous value);
      * Andrews' final ``max(w, 1e-4)`` applies *after* the ``e >= pi -> 0``
        zeroing, so no Andrews weight is ever below 1e-4;
      * Talwar assigns 1.0001 / 0 (not 1 / 0.0001 as its comment claims).
    """
    e2 = jnp.sum(E * E, axis=-1)
    en = jnp.sqrt(e2)

    if cost is Cost.L2:
        return prev_weights
    if cost is Cost.L05:
        w = jnp.power(jnp.maximum(e2, 1e-300), -3.0 / 8.0)
        return jnp.minimum(w, 1e4)
    if cost is Cost.L1:
        w = 1.0 / jnp.sqrt(jnp.maximum(en, 1e-300))
        return jnp.minimum(w, 1e4)
    if cost is Cost.L15:
        w = 1.0 / jnp.sqrt(jnp.sqrt(jnp.maximum(en, 1e-300)))
        return jnp.minimum(w, 1e4)
    if cost is Cost.GEMAN_MCCLURE:
        return 1.0 / (e2 + sigma * sigma)
    if cost is Cost.HUBER:
        t = 1.345 * sigma
        e = en / t
        return jnp.where(e >= 1, jnp.sqrt(_safe_div(1.0, e)), prev_weights)
    if cost is Cost.PSEUDO_HUBER:
        return 1.0 / jnp.sqrt(jnp.sqrt(1.0 + e2 / (sigma * sigma)))
    if cost is Cost.ANDREWS:
        t = 1.339 * sigma
        e = en / t
        ratio = _safe_div(jnp.sin(jnp.minimum(e, jnp.pi)), e)
        w = jnp.sqrt(jnp.maximum(ratio, 0.0))
        w = jnp.where(e >= jnp.pi, 0.0, w)
        w = jnp.where(e < 1e-4, 1.0, w)
        return jnp.maximum(w, 1e-4)
    if cost is Cost.BISQUARE:
        t = 4.685 * sigma
        return jnp.maximum(1.0 - e2 / (t * t), 1e-4)
    if cost is Cost.CAUCHY:
        t = 2.385 * sigma
        return 1.0 / jnp.sqrt(1.0 + e2 / (t * t))
    if cost is Cost.FAIR:
        t = 1.400 * sigma
        return 1.0 / jnp.sqrt(1.0 + en / t)
    if cost is Cost.LOGISTIC:
        t = 1.205 * sigma
        e = en / t
        w = jnp.sqrt(jnp.maximum(_safe_div(jnp.tanh(e), e), 0.0))
        return jnp.where(e < 1e-4, 1.0, w)
    if cost is Cost.TALWAR:
        t = 2.795 * sigma
        return jnp.where(e2 < t * t, 1.0001, 0.0)
    if cost is Cost.WELSCH:
        t = 2.985 * sigma
        return jnp.maximum(jnp.exp(-0.5 * e2 / (t * t)), 1e-4)
    raise ValueError(f"Unknown cost {cost}")


@dataclasses.dataclass(frozen=True)
class IRLSConfig:
    cost: Cost = Cost.GEMAN_MCCLURE
    sigma: float = 5.0 * jnp.pi / 180.0  # radians (reference default 5 deg)
    max_iters: int = 50
    change_th: float = 1e-3
    backend: str = "dense"  # "dense" (Cholesky) or "cg"
    ridge: float = 0.0
    cg_tol: float = 1e-10
    cg_maxiter: int = 1000


def _solve_wls(g: RotationGraph, coef, rhs, cfg: IRLSConfig):
    """Solve ``(A' diag(coef) A) X = rhs`` over free nodes; X=0 on fixed."""
    free = g.free_mask()
    if cfg.backend == "dense":
        X = laplacian_cho_solve(
            g.edges, coef, rhs, free, g.edge_mask, g.n, ridge=cfg.ridge
        )
        return jnp.where(free[:, None], X, 0.0)
    elif cfg.backend == "cg":
        X, _ = laplacian_cg_solve(
            g.edges, coef, rhs, free, g.edge_mask,
            tol=cfg.cg_tol, maxiter=cfg.cg_maxiter,
        )
        return X
    raise ValueError(f"Unknown backend {cfg.backend!r}")


def irls_step(g: RotationGraph, weights, cfg: IRLSConfig):
    """One IRLS iteration. Returns (new_Q, new_weights, score)."""
    free = g.free_mask()
    w4 = so3.delta_rel(g.edges, g.QQ, g.Q)
    w3 = so3.log_map(w4)[:, :3]
    w3 = jnp.where(g.edge_mask[:, None], w3, 0.0)

    wsq = weights * weights
    coef = jnp.where(g.edge_mask, wsq, 0.0)
    rhs = incidence_rmatvec(
        g.edges, wsq[:, None] * w3, free, g.edge_mask, g.n
    )
    X = _solve_wls(g, coef, rhs, cfg)

    E = incidence_matvec(g.edges, X, free, g.edge_mask) - w3
    new_weights = update_weights(cfg.cost, E, weights, cfg.sigma)

    norms = jnp.linalg.norm(X, axis=-1)
    n_free = jnp.maximum(jnp.sum(free), 1)
    score = jnp.sum(jnp.where(free, norms, 0.0)) / n_free

    dQ = so3.exp_map(X)  # identity rows where X == 0 (fixed/padded)
    new_Q = so3.qmul(g.Q, dQ)
    return new_Q, new_weights, score


@partial(jax.jit, static_argnames=("cfg",))
def irls(g: RotationGraph, cfg: IRLSConfig = IRLSConfig(), weights=None):
    """Run IRLS to convergence. Returns (Q, weights, iters, score).

    Weights start at ones (ral/l1_irls.cpp:577) so the first solve is
    unweighted; the loop stops when the mean free-node update norm drops to
    ``change_th`` or ``max_iters`` is hit.
    """
    if weights is None:
        weights = jnp.ones((g.m,), g.dtype)

    def cond(state):
        _, _, score, it = state
        return (score > cfg.change_th) & (it < cfg.max_iters)

    def body(state):
        Q, w, _, it = state
        gg = dataclasses.replace(g, Q=Q)
        Q2, w2, score = irls_step(gg, w, cfg)
        return Q2, w2, score, it + 1

    init = (g.Q, weights, jnp.asarray(jnp.inf, g.dtype), jnp.asarray(0, jnp.int32))
    Q, w, score, iters = jax.lax.while_loop(cond, body, init)
    return Q, w, iters, score
