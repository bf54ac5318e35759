"""Edge-sharded IRLS rotation averaging (`shard_map` + `psum`).

Partitioning scheme
-------------------
* ``edges/QQ/edge_mask/weights`` — sharded on the leading (edge) axis over
  the ``graph`` mesh axis.  Edge blocks are the unit of work: residual,
  log-map, robust weight update, and the Laplacian partials are all
  edge-local.
* ``Q/node_mask/rhs/x`` — replicated.  Node state is tiny ((n,4) floats)
  next to the edge data, so replicating it and reducing partials with one
  ``psum`` per matvec is the only collective (an NCCL all-reduce on GPUs)
  and avoids any gather of remote edge data.

Memory model (why node replication scales)
------------------------------------------
Per device, the solver state is ``O(m/D)`` edge data + ``O(n)`` replicated
node data, with n×(4 Q + 3 rhs + 4×3 CG vectors) ≈ 20 floats/node: about
80 MB of replicated state for a 1M-view problem, so the
``psum``-everything design holds to far beyond BASELINE config 5 (50k
views); node sharding would only matter past tens of millions of views.

Multi-host
----------
For problems spanning hosts, call :func:`init_multihost` first (a
thin `jax.distributed.initialize` wrapper), then build the mesh with
``make_graph_mesh()`` — `jax.devices()` is the *global* device list in a
multi-process run, and :func:`shard_graph` materialises only the shards a
process can address (`jax.make_array_from_callback`).  The single ``psum``
per CG matvec is one all-reduce across every device of every process.

This reproduces the semantics of the single-device solver in
``irotavg_tpu.solver.irls`` exactly (same masked math; the only difference
is summation order), and is validated against it in
``tests/test_parallel.py`` on a virtual 8-device CPU mesh.

The reference has no counterpart — its solve is a single-threaded
SuiteSparse factorization (ral/l1_irls.cpp:536-556).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from irotavg_tpu import so3
from irotavg_tpu.solver.graph import RotationGraph
from irotavg_tpu.solver.irls import Cost, IRLSConfig, update_weights

GRAPH_AXIS = "graph"


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, **kwargs):
    """Join a multi-host run and return (process_index, process_count).

    Thin wrapper over ``jax.distributed.initialize``: with no arguments it
    relies on the cluster environment (SLURM and similar schedulers set the
    coordinator env vars).  Safe to call in a single-process run —
    it becomes a no-op and returns ``(0, 1)``.  After this,
    ``jax.devices()`` is the global device list and
    :func:`make_graph_mesh` / :func:`shard_graph` span the whole pod.
    """
    # Decide from the arguments/environment ONLY: jax.process_count()
    # initialises the XLA backend, after which jax.distributed.initialize
    # raises ("initialize() must be called before any JAX calls ...").
    want_multi = (coordinator_address is not None
                  or num_processes not in (None, 1)
                  or "JAX_COORDINATOR_ADDRESS" in __import__("os").environ)
    if want_multi and not jax.distributed.is_initialized():
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id, **kwargs
        )
    return jax.process_index(), jax.process_count()


def make_graph_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the edge-parallel ``graph`` axis.

    In a multi-process run (after :func:`init_multihost`) this spans every
    device of every process, in JAX's default order; the mesh follows the
    algorithm alone (one edge axis), not the interconnect.
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (GRAPH_AXIS,), devices=devices)


def shard_graph(g: RotationGraph, mesh: Mesh) -> RotationGraph:
    """Place a (pre-padded) graph on the mesh: edge arrays sharded on the
    leading axis, node arrays replicated.  ``g.m`` must divide evenly by the
    mesh size (pad with masked edges first: ``g.pad_to``).

    Uses ``jax.make_array_from_callback`` so each process materialises only
    its addressable shards — the same call works on one host and on a
    multi-host mesh (where ``device_put`` of a host-global array would not).
    """
    n_dev = mesh.shape[GRAPH_AXIS]
    if g.m % n_dev:
        raise ValueError(f"edge count {g.m} not divisible by mesh size {n_dev}")
    edge_sh = NamedSharding(mesh, P(GRAPH_AXIS))
    repl = NamedSharding(mesh, P())

    def put(x, sh):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

    return RotationGraph(
        edges=put(g.edges, edge_sh),
        QQ=put(g.QQ, edge_sh),
        Q=put(g.Q, repl),
        f=jax.device_put(g.f, repl),
        edge_mask=put(g.edge_mask, edge_sh),
        node_mask=put(g.node_mask, repl),
    )


# ---------------------------------------------------------------------------
# Per-shard primitives (run inside shard_map; arrays are local edge blocks).
# ---------------------------------------------------------------------------


def _local_matvec(edges, coef, x, free_mask, edge_mask, n):
    """This shard's contribution to ``A' diag(coef) A x`` (psum to combine)."""
    xf = jnp.where(free_mask[:, None], x, 0.0)
    e = (xf[edges[:, 1]] - xf[edges[:, 0]]) * jnp.where(edge_mask, coef, 0.0)[:, None]
    out = jnp.zeros((n, x.shape[1]), x.dtype)
    out = out.at[edges[:, 1]].add(e)
    out = out.at[edges[:, 0]].add(-e)
    return jnp.where(free_mask[:, None], out, 0.0)


def _local_diag(edges, coef, free_mask, edge_mask, n):
    c = jnp.where(edge_mask, coef, 0.0)
    d = jnp.zeros((n,), coef.dtype)
    d = d.at[edges[:, 0]].add(c)
    d = d.at[edges[:, 1]].add(c)
    return d


def _pcg(edges, coef, rhs, free_mask, edge_mask, *, tol, maxiter):
    """Jacobi-preconditioned CG with one ``psum`` per matvec.

    All (n,k) vectors are replicated across shards; the matvec partials and
    the Jacobi diagonal are the only quantities reduced over the mesh.  CG
    scalars (dot products of replicated vectors) need no collective.
    """
    n = rhs.shape[0]
    dtype = rhs.dtype

    def matvec(x):
        part = _local_matvec(edges, coef, x, free_mask, edge_mask, n)
        return jax.lax.psum(part, GRAPH_AXIS)

    d = jax.lax.psum(_local_diag(edges, coef, free_mask, edge_mask, n), GRAPH_AXIS)
    # guard d == 0 (free node with all incident weights zeroed) — matches
    # solver.graph.laplacian_diag: unit diagonal keeps CG finite and leaves
    # the unconstrained node at a zero (minimum-norm) update
    dinv = 1.0 / jnp.where(free_mask & (d > 0), d, 1.0)

    b = jnp.where(free_mask[:, None], rhs, 0.0)
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = dinv[:, None] * r0
    rz0 = jnp.sum(r0 * z0)
    bnorm = jnp.sqrt(jnp.sum(b * b)) + jnp.asarray(1e-300, dtype)

    def cond(state):
        _, r, _, _, k = state
        return (jnp.sqrt(jnp.sum(r * r)) > tol * bnorm) & (k < maxiter)

    def body(state):
        x, r, p, rz, k = state
        Ap = matvec(p)
        denom = jnp.sum(p * Ap)
        alpha = rz / jnp.where(denom != 0, denom, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv[:, None] * r
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.where(rz != 0, rz, 1.0)
        return x, r, z + beta * p, rz_new, k + 1

    x, _, _, _, _ = jax.lax.while_loop(
        cond, body, (x0, r0, z0, rz0, jnp.asarray(0, jnp.int32))
    )
    return x


def _irls_step_shard(edges, QQ, edge_mask, weights, Q, f, node_mask, cfg: IRLSConfig):
    """One IRLS iteration on this shard's edge block; Q replicated.

    Returns (new_Q replicated, new local weights, global score).
    """
    n = Q.shape[0]
    idx = jnp.arange(n)
    free = (idx >= f) & node_mask

    w4 = so3.delta_rel(edges, QQ, Q)
    w3 = so3.log_map(w4)[:, :3]
    w3 = jnp.where(edge_mask[:, None], w3, 0.0)

    wsq = weights * weights
    coef = jnp.where(edge_mask, wsq, 0.0)

    rhs_part = jnp.zeros((n, 3), Q.dtype)
    rhs_part = rhs_part.at[edges[:, 1]].add(wsq[:, None] * w3)
    rhs_part = rhs_part.at[edges[:, 0]].add(-(wsq[:, None] * w3))
    rhs = jax.lax.psum(jnp.where(free[:, None], rhs_part, 0.0), GRAPH_AXIS)

    X = _pcg(
        edges, coef, rhs, free, edge_mask, tol=cfg.cg_tol, maxiter=cfg.cg_maxiter
    )

    Xf = jnp.where(free[:, None], X, 0.0)
    E = (Xf[edges[:, 1]] - Xf[edges[:, 0]]) - w3
    E = jnp.where(edge_mask[:, None], E, 0.0)
    new_weights = update_weights(cfg.cost, E, weights, cfg.sigma)

    norms = jnp.linalg.norm(X, axis=-1)
    n_free = jnp.maximum(jnp.sum(free), 1)
    score = jnp.sum(jnp.where(free, norms, 0.0)) / n_free

    new_Q = so3.qmul(Q, so3.exp_map(X))
    return new_Q, new_weights, score


def sharded_irls_step(mesh: Mesh, cfg: IRLSConfig):
    """Build the jittable one-step update over ``mesh``.

    Returns ``step(g, weights) -> (Q, weights, score)`` with edge arrays
    sharded over ``graph`` and node arrays replicated.  This is the
    "training step" of the framework: call it in a loop, or use
    :func:`sharded_irls` for the converged solve.
    """
    spec_e = P(GRAPH_AXIS)
    spec_r = P()

    fn = shard_map(
        partial(_irls_step_shard, cfg=cfg),
        mesh=mesh,
        in_specs=(spec_e, spec_e, spec_e, spec_e, spec_r, spec_r, spec_r),
        out_specs=(spec_r, spec_e, spec_r),
    )

    @jax.jit
    def step(g: RotationGraph, weights):
        return fn(g.edges, g.QQ, g.edge_mask, weights, g.Q, g.f, g.node_mask)

    return step


def sharded_irls(mesh: Mesh, cfg: IRLSConfig = IRLSConfig()):
    """Converged distributed IRLS: same contract as ``solver.irls.irls`` but
    running edge-parallel over ``mesh``.  Returns ``solve(g, weights=None)
    -> (Q, weights, iters, score)``."""
    spec_e = P(GRAPH_AXIS)
    spec_r = P()

    def _loop_shard(edges, QQ, edge_mask, weights, Q, f, node_mask):
        def cond(state):
            _, _, score, it = state
            return (score > cfg.change_th) & (it < cfg.max_iters)

        def body(state):
            Qc, w, _, it = state
            Q2, w2, score = _irls_step_shard(
                edges, QQ, edge_mask, w, Qc, f, node_mask, cfg
            )
            return Q2, w2, score, it + 1

        init = (Q, weights, jnp.asarray(jnp.inf, Q.dtype), jnp.asarray(0, jnp.int32))
        Qn, w, score, iters = jax.lax.while_loop(cond, body, init)
        return Qn, w, iters, score

    fn = shard_map(
        _loop_shard,
        mesh=mesh,
        in_specs=(spec_e, spec_e, spec_e, spec_e, spec_r, spec_r, spec_r),
        out_specs=(spec_r, spec_e, spec_r, spec_r),
    )

    @jax.jit
    def solve(g: RotationGraph, weights=None):
        if weights is None:
            weights = jnp.ones((g.m,), g.dtype)
        return fn(g.edges, g.QQ, g.edge_mask, weights, g.Q, g.f, g.node_mask)

    return solve


def sharded_ravg_pipeline(mesh: Mesh, *, l1_iters: int = 5,
                          cfg: IRLSConfig = IRLSConfig()):
    """Full distributed batch solve matching the single-device pipeline's
    contract (robust pre-fit, then the configured cost to convergence).

    The reference runs `l1ra` before `irls` so gross outliers cannot
    poison the least-squares phase (ral/test.cpp:286-300).  The L1 IRLS
    fixed point minimises the same objective as the ℓ1 decoder, so the
    distributed pipeline uses ``Cost.L1`` weights for the warmup — every
    iteration stays edge-parallel with one ``psum`` per CG matvec, no
    interior-point inner solves.

    Returns ``solve(g, weights=None) -> (Q, weights, iters, score)``.
    """
    spec_e = P(GRAPH_AXIS)
    spec_r = P()
    l1_cfg = dataclasses.replace(cfg, cost=Cost.L1, max_iters=l1_iters)

    def _loop(edges, QQ, edge_mask, weights, Q, f, node_mask):
        def make_phase(phase_cfg):
            def cond(state):
                _, _, score, it = state
                return (score > phase_cfg.change_th) & (it < phase_cfg.max_iters)

            def body(state):
                Qc, w, _, it = state
                Q2, w2, score = _irls_step_shard(
                    edges, QQ, edge_mask, w, Qc, f, node_mask, phase_cfg
                )
                return Q2, w2, score, it + 1

            return cond, body

        c1, b1 = make_phase(l1_cfg)
        init = (Q, weights, jnp.asarray(jnp.inf, Q.dtype),
                jnp.asarray(0, jnp.int32))
        Q1, _, _, it1 = jax.lax.while_loop(c1, b1, init)

        c2, b2 = make_phase(cfg)
        # the robust phase restarts from unit weights (ral/l1_irls.cpp:577)
        init2 = (Q1, jnp.ones_like(weights), jnp.asarray(jnp.inf, Q.dtype),
                 jnp.asarray(0, jnp.int32))
        Q2, w, score, it2 = jax.lax.while_loop(c2, b2, init2)
        return so3.qnormalize(Q2), w, it1 + it2, score

    fn = shard_map(
        _loop,
        mesh=mesh,
        in_specs=(spec_e, spec_e, spec_e, spec_e, spec_r, spec_r, spec_r),
        out_specs=(spec_r, spec_e, spec_r, spec_r),
    )

    @jax.jit
    def solve(g: RotationGraph, weights=None):
        if weights is None:
            weights = jnp.ones((g.m,), g.dtype)
        return fn(g.edges, g.QQ, g.edge_mask, weights, g.Q, g.f, g.node_mask)

    return solve
