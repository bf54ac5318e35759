"""Array-native rotation-averaging problem representation.

The reference encodes the problem as `Q (n,4)`, `QQ (m,4)`, an edge list
`I_t`, and an integer `f` marking how many leading rotations are fixed
(ral/l1_irls.hpp:84-112).  Here the same data is a pytree of statically
shaped arrays.  Fixedness is a *traced* scalar `f` plus derived masks, so a
sliding-window incremental solver can change `f` without recompiling; padding
is expressed with an `edge_mask` so graphs of varying size reuse one
compiled executable per bucket.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RotationGraph:
    """A (possibly padded) rotation-averaging problem.

    Attributes:
      edges:  ``(m, 2)`` int32 — per-edge node indices ``(i, j)``; the edge
              constraint is ``R_j ≈ R_ij R_i`` (reference convention,
              ral/l1_irls.cpp:109-127).  Padded edges may point at node 0.
      QQ:     ``(m, 4)`` — relative rotations ``[x y z w]`` per edge.
      Q:      ``(n, 4)`` — absolute rotation estimates; first ``f`` fixed.
      f:      scalar int32 — number of leading fixed rotations (traced).
      edge_mask: ``(m,)`` bool — True for real edges, False for padding.
      node_mask: ``(n,)`` bool — True for real nodes, False for padding.
    """

    edges: jax.Array
    QQ: jax.Array
    Q: jax.Array
    f: jax.Array
    edge_mask: jax.Array
    node_mask: jax.Array

    @property
    def m(self) -> int:
        return self.edges.shape[0]

    @property
    def n(self) -> int:
        return self.Q.shape[0]

    @property
    def dtype(self):
        return self.Q.dtype

    def free_mask(self) -> jax.Array:
        """(n,) bool — nodes that are variables (index >= f and not padding)."""
        idx = jnp.arange(self.n)
        return (idx >= self.f) & self.node_mask

    @staticmethod
    def create(edges, QQ, Q, f=1, edge_mask=None, node_mask=None, dtype=None):
        edges = jnp.asarray(edges, jnp.int32)
        QQ = jnp.asarray(QQ)
        Q = jnp.asarray(Q)
        if dtype is not None:
            QQ = QQ.astype(dtype)
            Q = Q.astype(dtype)
        m, n = edges.shape[0], Q.shape[0]
        if edge_mask is None:
            edge_mask = jnp.ones((m,), bool)
        if node_mask is None:
            node_mask = jnp.ones((n,), bool)
        return RotationGraph(
            edges=edges,
            QQ=QQ,
            Q=Q,
            f=jnp.asarray(f, jnp.int32),
            edge_mask=jnp.asarray(edge_mask, bool),
            node_mask=jnp.asarray(node_mask, bool),
        )

    def pad_to(self, m_pad: int, n_pad: int) -> "RotationGraph":
        """Pad to ``m_pad`` edges / ``n_pad`` nodes (bucketed compilation)."""
        if m_pad < self.m or n_pad < self.n:
            raise ValueError("pad_to cannot shrink the problem")
        dm, dn = m_pad - self.m, n_pad - self.n
        ident = jnp.zeros((dn, 4), self.Q.dtype).at[:, 3].set(1.0)
        identm = jnp.zeros((dm, 4), self.QQ.dtype).at[:, 3].set(1.0)
        return RotationGraph(
            edges=jnp.concatenate(
                [self.edges, jnp.zeros((dm, 2), jnp.int32)], axis=0
            ),
            QQ=jnp.concatenate([self.QQ, identm], axis=0),
            Q=jnp.concatenate([self.Q, ident], axis=0),
            f=self.f,
            edge_mask=jnp.concatenate([self.edge_mask, jnp.zeros((dm,), bool)]),
            node_mask=jnp.concatenate([self.node_mask, jnp.zeros((dn,), bool)]),
        )


# ---------------------------------------------------------------------------
# Incidence-operator primitives.
#
# The reference materialises the m x (n-f) signed incidence matrix A
# (`make_A`, ral/l1_irls.cpp:755-780): row k has +1 at column (j-f) and -1 at
# column (i-f), with entries for fixed nodes dropped.  Here we never build A:
# we work in the *full* node space with variables zeroed on fixed nodes, which
# is algebraically identical and keeps shapes independent of f.
# ---------------------------------------------------------------------------


def incidence_matvec(edges, x_nodes, free_mask, edge_mask):
    """``A @ x`` per edge: ``x[j] - x[i]`` with fixed/padded nodes reading 0.

    Args:
      x_nodes: ``(n, k)`` values per node (zeros at fixed nodes are enforced).
      Returns ``(m, k)``.
    """
    x = jnp.where(free_mask[:, None], x_nodes, 0.0)
    out = x[edges[:, 1]] - x[edges[:, 0]]
    return jnp.where(edge_mask[:, None], out, 0.0)


def incidence_rmatvec(edges, e, free_mask, edge_mask, n):
    """``A.T @ e``: scatter ``+e_k`` to node j, ``-e_k`` to node i.

    Args:
      e: ``(m, k)`` per-edge values.  Returns ``(n, k)`` zeroed at fixed nodes.
    """
    e = jnp.where(edge_mask[:, None], e, 0.0)
    out = jnp.zeros((n, e.shape[1]), e.dtype)
    out = out.at[edges[:, 1]].add(e)
    out = out.at[edges[:, 0]].add(-e)
    return jnp.where(free_mask[:, None], out, 0.0)


def incidence_fixed_matvec(edges, x_nodes, free_mask, edge_mask):
    """``C @ x``: the incidence action over the *fixed* block — per edge,
    ``x[j]·[j fixed] − x[i]·[i fixed]``.

    Complement of :func:`incidence_matvec`, so that for any node field x
    ``A@x_free + C@x_fixed == x[j] − x[i]`` on real edges.  Parity with the
    reference's `make_C` (ral/l1_irls.cpp:783-806 — built but never called
    there; provided here because the full-node-space formulation makes it
    one line and it is useful for moving known rotations to the RHS when
    solving shard subproblems).
    """
    x = jnp.where(free_mask[:, None], 0.0, x_nodes)
    out = x[edges[:, 1]] - x[edges[:, 0]]
    return jnp.where(edge_mask[:, None], out, 0.0)


def laplacian_diag(edges, coef, free_mask, edge_mask, n):
    """Diagonal of ``A.T diag(coef) A`` in full node space (Jacobi precond)."""
    c = jnp.where(edge_mask, coef, 0.0)
    d = jnp.zeros((n,), coef.dtype)
    d = d.at[edges[:, 0]].add(c)
    d = d.at[edges[:, 1]].add(c)
    # guard d == 0 (a free node whose incident weights are all zero, e.g.
    # Talwar marking every neighbour an outlier): unit diagonal keeps the
    # preconditioner finite and, with rhs == 0 there, CG leaves the node at
    # zero update — the minimum-norm behaviour of the reference's SPQR
    return jnp.where(free_mask & (d > 0), d, 1.0)


def laplacian_dense(edges, coef, free_mask, edge_mask, n, ridge=0.0):
    """Dense ``A.T diag(coef) A`` with Dirichlet (identity) rows/cols on fixed
    nodes — ready for a single Cholesky factorization.

    Equivalent to the reference's Gram matrix of `make_A` columns restricted
    to free nodes (`make_AtA` trick, ral/l1_irls.cpp:811-848), embedded in
    full node space so `f` can stay a traced value.
    """
    c = jnp.where(edge_mask, coef, 0.0)
    i, j = edges[:, 0], edges[:, 1]
    fi = free_mask[i]
    fj = free_mask[j]
    L = jnp.zeros((n, n), coef.dtype)
    L = L.at[i, i].add(jnp.where(fi, c, 0.0))
    L = L.at[j, j].add(jnp.where(fj, c, 0.0))
    both = fi & fj
    L = L.at[i, j].add(jnp.where(both, -c, 0.0))
    L = L.at[j, i].add(jnp.where(both, -c, 0.0))
    fixed_diag = jnp.where(free_mask, ridge, 1.0)
    return L + jnp.diag(fixed_diag)


def laplacian_cho_solve(edges, coef, rhs, free_mask, edge_mask, n, ridge=0.0):
    """Dense Cholesky solve of ``(A' diag(coef) A) X = rhs`` with a
    singularity rescue.

    A window whose robust weights zero out every edge of a free node, or a
    free component with no path to any fixed node, makes the Dirichlet
    Laplacian singular; the reference aborts the process on the equivalent
    UMFPACK failure (ral/l1_irls.cpp:149-177).  Here the factorisation is
    attempted as-is and, only if it produced non-finite values, re-run with
    a tiny relative Tikhonov shift on the free diagonal — unconstrained
    directions then receive a (near) minimum-norm zero update instead of
    NaNs, and well-posed solves stay bit-identical to the unshifted path.
    """
    L = laplacian_dense(edges, coef, free_mask, edge_mask, n, ridge=ridge)
    X = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(L), rhs)

    def rescue(_):
        n_free = jnp.maximum(jnp.sum(free_mask), 1)
        scale = jnp.sum(jnp.where(free_mask, jnp.diagonal(L), 0.0)) / n_free
        eps = jnp.asarray(
            1e-6 if L.dtype == jnp.float32 else 1e-10, L.dtype
        )
        shift = jnp.maximum(scale, 1.0) * eps
        L2 = L + jnp.diag(jnp.where(free_mask, shift, 0.0))
        X2 = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(L2), rhs)
        return jnp.where(jnp.isfinite(X2), X2, 0.0)

    ok = jnp.all(jnp.isfinite(X))
    return jax.lax.cond(ok, lambda _: X, rescue, None)


@partial(jax.jit, static_argnames=("maxiter",))
def laplacian_cg_solve(
    edges, coef, rhs, free_mask, edge_mask, *, tol=1e-10, maxiter=500
):
    """Matrix-free Jacobi-preconditioned CG for ``(A.T diag(coef) A) x = rhs``.

    The SpMV is two gathers + two scatter-adds per iteration — bandwidth
    bound, shardable over edge blocks with `psum` (see parallel/).
    rhs: ``(n, k)``; solves all k RHS simultaneously.
    """
    n = rhs.shape[0]
    dtype = rhs.dtype

    def matvec(x):
        e = incidence_matvec(edges, x, free_mask, edge_mask)
        e = e * jnp.where(edge_mask, coef, 0.0)[:, None]
        return incidence_rmatvec(edges, e, free_mask, edge_mask, n)

    dinv = 1.0 / laplacian_diag(edges, coef, free_mask, edge_mask, n)
    b = jnp.where(free_mask[:, None], rhs, 0.0)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = dinv[:, None] * r0
    p0 = z0
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
        p = z + beta * p
        return x, r, p, rz_new, k + 1

    x, _, _, _, iters = jax.lax.while_loop(
        cond, body, (x0, r0, p0, rz0, jnp.asarray(0, jnp.int32))
    )
    return x, iters
