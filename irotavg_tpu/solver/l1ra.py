"""L1 rotation averaging (array-native `l1ra`, ral/l1_irls.cpp:851-912).

Outer Lie-algebra loop: residual -> log-map -> three independent scalar
l1-minimisation problems ``min ||A x - y||_1`` (one per tangent axis,
ral/l1_irls.cpp:890-892) -> exp-map -> right-multiplied update.

The inner decoder is the primal-dual interior-point method of l1-magic
(`l1decode_pd`, ral/l1_irls.cpp:228-468; the MATLAB original is inlined there
as comments, which we use as the spec).  Array re-design:

  * the three axes run as one `vmap`, so each Newton step factorises a
    batched (3, n, n) SPD system — the Newton matrix
    ``A' diag(sigx) A`` is SPD because ``sigx = sig1 - sig2^2/sig1`` is the
    Schur complement of the positive 2x2 block ``[[sig1, sig2], [sig2,
    sig1]]``  (``sig1^2 - sig2^2 = 4 lamu1 lamu2/(fu1 fu2) > 0``);
  * every reduction is masked so padded edges cannot perturb the solve —
    padded rows are re-pinned to a neutral interior point each iteration;
  * the reference's adaptive ``l1_step``/threshold schedule
    (ral/l1_irls.cpp:879-883) is dead code — its guard can only trigger when
    the loop has already exited — so each outer iteration runs the decoder
    with a fixed ``pd_iters`` (= 2, matching the effective behavior).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from irotavg_tpu import so3
from irotavg_tpu.solver.graph import (
    RotationGraph,
    incidence_matvec,
    incidence_rmatvec,
    laplacian_cg_solve,
    laplacian_dense,
)

PDTOL = 1e-3  # ral/l1_irls.cpp:231
_ALPHA = 0.01
_BETA = 0.5
_MU = 10.0
_MAX_BACKTRACK = 32


@dataclasses.dataclass(frozen=True)
class L1RAConfig:
    max_iters: int = 5
    change_th: float = 1e-3
    pd_iters: int = 2  # Newton iterations per decode (l1_step, fixed)
    ridge: float = 0.0
    backend: str = "dense"  # "dense" (Cholesky) or "cg" (matrix-free)
    cg_tol: float = 1e-10
    cg_maxiter: int = 1000


def _masked_norm2(x, mask):
    return jnp.sum(jnp.where(mask, x * x, 0.0))


def _l1decode_pd_single(y, edges, free, emask, n, pd_iters, ridge,
                        backend="dense", cg_tol=1e-10, cg_maxiter=1000):
    """One scalar l1 decode ``argmin_x ||A x - y||_1`` from x0 = 0.

    All (m,) quantities are masked by ``emask``; x lives in full node space
    (zeros on fixed nodes).  Returns x (n,).
    """
    dtype = y.dtype
    m = y.shape[0]
    m_eff = jnp.maximum(jnp.sum(emask.astype(dtype)), 1.0)
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)

    def Aop(x):
        return incidence_matvec(edges, x[:, None], free, emask)[:, 0]

    def Atop(e):
        return incidence_rmatvec(edges, e[:, None], free, emask, n)[:, 0]

    def pin(fu1, fu2, lamu1, lamu2, u):
        """Neutral interior values on padded rows (excluded from reductions)."""
        fu1 = jnp.where(emask, fu1, -1.0)
        fu2 = jnp.where(emask, fu2, -1.0)
        lamu1 = jnp.where(emask, lamu1, 1.0)
        lamu2 = jnp.where(emask, lamu2, 1.0)
        u = jnp.where(emask, u, 1.0)
        return fu1, fu2, lamu1, lamu2, u

    x = jnp.zeros((n,), dtype)
    Ax = jnp.zeros((m,), dtype)
    r_abs = jnp.where(emask, jnp.abs(y - Ax), 0.0)
    u = 0.95 * r_abs + 0.10 * jnp.max(r_abs)
    fu1 = Ax - y - u
    fu2 = -Ax + y - u
    lamu1 = -1.0 / fu1
    lamu2 = -1.0 / fu2
    fu1, fu2, lamu1, lamu2, u = pin(fu1, fu2, lamu1, lamu2, u)
    Atv = Atop(lamu1 - lamu2)

    def sdg_of(fu1, fu2, lamu1, lamu2):
        return -(
            jnp.sum(jnp.where(emask, fu1 * lamu1, 0.0))
            + jnp.sum(jnp.where(emask, fu2 * lamu2, 0.0))
        )

    sdg = sdg_of(fu1, fu2, lamu1, lamu2)
    tau = _MU * 2.0 * m_eff / sdg

    def resnorm_of(rd_x, rd_u, fu1, fu2, lamu1, lamu2, tau):
        rc1 = -lamu1 * fu1 - 1.0 / tau
        rc2 = -lamu2 * fu2 - 1.0 / tau
        return jnp.sqrt(
            jnp.sum(jnp.where(free, rd_x * rd_x, 0.0))
            + _masked_norm2(rd_u, emask)
            + _masked_norm2(rc1, emask)
            + _masked_norm2(rc2, emask)
        )

    rd_x = Atv
    rd_u = 1.0 - lamu1 - lamu2
    resnorm = resnorm_of(rd_x, rd_u, fu1, fu2, lamu1, lamu2, tau)

    State = tuple  # (x, u, Ax, Atv, lamu1, lamu2, fu1, fu2, sdg, tau,
    #                resnorm, rd_x, rd_u, it, done)

    def cond(s: State):
        return ~s[-1]

    def body(s: State):
        (x, u, Ax, Atv, lamu1, lamu2, fu1, fu2, sdg, tau, resnorm,
         rd_x, rd_u, it, _) = s
        fu1, fu2, lamu1, lamu2, u = pin(fu1, fu2, lamu1, lamu2, u)

        inv_fu1 = 1.0 / fu1
        inv_fu2 = 1.0 / fu2
        w2 = -1.0 - (1.0 / tau) * (inv_fu1 + inv_fu2)
        sig1 = -lamu1 * inv_fu1 - lamu2 * inv_fu2
        sig2 = lamu1 * inv_fu1 - lamu2 * inv_fu2
        sigx = sig1 - sig2 * sig2 / sig1
        w1 = -(1.0 / tau) * Atop(-inv_fu1 + inv_fu2)
        w1p = w1 - Atop((sig2 / sig1) * w2)

        if backend == "dense":
            # No lax.cond rescue here: this function runs under a 3-axis
            # vmap, where cond lowers to select and BOTH branches execute —
            # a conditional re-factorisation would double the Cholesky work
            # of every Newton step.  The never-NaN policy is kept by
            # zeroing a non-finite solve instead.  H = A'diag(sigx)A with
            # sigx > 0 on real edges is singular only for a free node with
            # no real edges — but note the blast radius: a NaN pivot
            # contaminates all later-ordered rows of the factor, so dx is
            # zeroed for every healthy node ordered after it too, stalling
            # them for that one Newton step (they resume next iteration).
            # Windows produced by the incremental engine are connected, so
            # this path only fires on malformed standalone problems.
            H = laplacian_dense(edges, sigx, free, emask, n, ridge=ridge)
            dx = jax.scipy.linalg.cho_solve(
                jax.scipy.linalg.cho_factor(H), w1p[:, None]
            )[:, 0]
            dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        else:  # matrix-free Jacobi-CG: O(m) per matvec, no n^2 Laplacian
            dx = laplacian_cg_solve(
                edges, sigx, w1p[:, None], free, emask,
                tol=cg_tol, maxiter=cg_maxiter,
            )[0][:, 0]
        dx = jnp.where(free, dx, 0.0)
        Adx = Aop(dx)

        du = (w2 - sig2 * Adx) / sig1
        dlamu1 = -(lamu1 * inv_fu1) * (Adx - du) - lamu1 - (1.0 / tau) * inv_fu1
        dlamu2 = (lamu2 * inv_fu2) * (Adx + du) - lamu2 - (1.0 / tau) * inv_fu2
        Atdv = Atop(dlamu1 - dlamu2)

        # feasibility step: keep lamu > 0, fu < 0 (masked mins)
        def ratio_min(neg_num, den, pred):
            vals = jnp.where(pred & emask, neg_num / den, big)
            return jnp.min(vals)

        s_step = jnp.asarray(1.0, dtype)
        s_step = jnp.minimum(s_step, ratio_min(-lamu1, dlamu1, dlamu1 < 0))
        s_step = jnp.minimum(s_step, ratio_min(-lamu2, dlamu2, dlamu2 < 0))
        s_step = jnp.minimum(
            s_step, ratio_min(-fu1, Adx - du, (Adx - du) > 0)
        )
        s_step = jnp.minimum(
            s_step, ratio_min(-fu2, -Adx - du, (-Adx - du) > 0)
        )
        s_step = 0.99 * s_step

        # backtracking line search (ral/l1_irls.cpp:385-432)
        def trial(sv):
            xp = x + sv * dx
            up = u + sv * du
            Axp = Ax + sv * Adx
            Atvp = Atv + sv * Atdv
            l1p = lamu1 + sv * dlamu1
            l2p = lamu2 + sv * dlamu2
            f1p = Axp - y - up
            f2p = -Axp + y - up
            rdxp = 1.0 * Atvp
            rdup = 1.0 - l1p - l2p
            rn = resnorm_of(rdxp, rdup, f1p, f2p, l1p, l2p, tau)
            return (xp, up, Axp, Atvp, l1p, l2p, f1p, f2p, rdxp, rdup, rn)

        def bt_cond(bs):
            sv, ok, k, _ = bs
            return (~ok) & (k <= _MAX_BACKTRACK)

        def bt_body(bs):
            sv, _, k, _ = bs
            t = trial(sv)
            ok = t[-1] <= (1.0 - _ALPHA * sv) * resnorm
            return sv * _BETA, ok, k + 1, t

        t0 = trial(s_step)
        ok0 = t0[-1] <= (1.0 - _ALPHA * s_step) * resnorm
        sv, ok, backiter, t = jax.lax.while_loop(
            bt_cond, bt_body, (s_step * _BETA, ok0, jnp.asarray(1, jnp.int32), t0)
        )
        stuck = ~ok  # exceeded backtrack budget: keep last iterate, stop

        (xp, up, Axp, Atvp, l1p, l2p, f1p, f2p, rdxp, rdup, rn) = t
        xn = jnp.where(stuck, x, xp)
        un = jnp.where(stuck, u, up)
        Axn = jnp.where(stuck, Ax, Axp)
        Atvn = jnp.where(stuck, Atv, Atvp)
        l1n = jnp.where(stuck, lamu1, l1p)
        l2n = jnp.where(stuck, lamu2, l2p)
        f1n = jnp.where(stuck, fu1, f1p)
        f2n = jnp.where(stuck, fu2, f2p)
        rdxn = jnp.where(stuck, rd_x, rdxp)
        rdun = jnp.where(stuck, rd_u, rdup)

        sdg_n = sdg_of(f1n, f2n, l1n, l2n)
        tau_n = _MU * 2.0 * m_eff / sdg_n
        resnorm_n = resnorm_of(rdxn, rdun, f1n, f2n, l1n, l2n, tau_n)

        it_n = it + 1
        done = stuck | (sdg_n < PDTOL) | (it_n >= pd_iters)
        return (xn, un, Axn, Atvn, l1n, l2n, f1n, f2n, sdg_n, tau_n,
                resnorm_n, rdxn, rdun, it_n, done)

    init_done = sdg < PDTOL
    init: State = (x, u, Ax, Atv, lamu1, lamu2, fu1, fu2, sdg, tau,
                   resnorm, rd_x, rd_u, jnp.asarray(0, jnp.int32), init_done)
    out = jax.lax.while_loop(cond, body, init)
    return out[0]


def l1ra_step(g: RotationGraph, cfg: L1RAConfig):
    """One outer L1-RA iteration. Returns (new_Q, score)."""
    free = g.free_mask()
    w4 = so3.delta_rel(g.edges, g.QQ, g.Q)
    w3 = so3.log_map(w4)[:, :3]
    w3 = jnp.where(g.edge_mask[:, None], w3, 0.0)

    decode = partial(
        _l1decode_pd_single,
        edges=g.edges,
        free=free,
        emask=g.edge_mask,
        n=g.n,
        pd_iters=cfg.pd_iters,
        ridge=cfg.ridge,
        backend=cfg.backend,
        cg_tol=cfg.cg_tol,
        cg_maxiter=cfg.cg_maxiter,
    )
    X = jax.vmap(decode)(w3.T).T  # (n, 3); batched Newton solves

    norms = jnp.linalg.norm(X, axis=-1)
    n_free = jnp.maximum(jnp.sum(free), 1)
    score = jnp.sum(jnp.where(free, norms, 0.0)) / n_free

    new_Q = so3.qmul(g.Q, so3.exp_map(X))
    return new_Q, score


@partial(jax.jit, static_argnames=("cfg",))
def l1ra(g: RotationGraph, cfg: L1RAConfig = L1RAConfig()):
    """Run L1-RA. Returns (Q, iters, score).

    Loop contract matches ral/l1_irls.cpp:879-910: iterate while the mean
    free-node tangent-update norm >= ``change_th`` (note: >=, unlike IRLS's
    strict >), up to ``max_iters``.
    """

    def cond(state):
        _, score, it = state
        return (score >= cfg.change_th) & (it < cfg.max_iters)

    def body(state):
        Q, _, it = state
        gg = dataclasses.replace(g, Q=Q)
        Q2, score = l1ra_step(gg, cfg)
        return Q2, score, it + 1

    init = (g.Q, jnp.asarray(jnp.inf, g.dtype), jnp.asarray(0, jnp.int32))
    Q, score, iters = jax.lax.while_loop(cond, body, init)
    return Q, iters, score
