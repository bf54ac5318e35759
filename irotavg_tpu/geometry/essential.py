"""Batched essential-matrix estimation (8-point RANSAC) and pose recovery.

Contract parity with cv::findEssentialMat(..., RANSAC, prob, th) +
cv::recoverPose as used by `ViewGraph::findRelativePose`
(src/ViewGraph.cpp:600-650): normalised image coordinates, Sampson
distance threshold ``th / focal``, cheirality by triangulated-depth
counting with a 50-unit distance cutoff.  Deliberate divergence: the
hypothesis solver is the 8-point algorithm over a fixed batch of S random
minimal samples (vs OpenCV's adaptive-count Nister 5-point) — the whole
hypothesis batch solves in one device program, and S is sized for inlier
ratios well below SLAM operating points.

Numerics: XLA lowers `eigh`/`svd` to iterative programs, so the hot
decompositions are closed-form / fixed-sweep primitives that lower to
elementwise ops and tiny matmuls:

  * symmetric 3x3 eigendecomposition: five unrolled cyclic-Jacobi sweeps
    (`_sym3x3_jacobi`) — exact to f32 precision in <= 15 rotations;
  * SVD of E: eigendecomposition of E^T E + back-substituted left vectors
    (`_svd3x3`) — replaces per-call `svd` in projection and pose recovery;
  * triangulation: closed-form two-ray depth solve (2x2 normal equations,
    `_ray_depths`) instead of a per-point 4x4 DLT eigenproblem — this was
    the dominant cost (a (4, N) batch of eigh per recover_pose);
  * minimal-sample 8-point null vectors: unrolled batched Householder QR
    of the Hartley-normalised (8, 9) design (`_nullvec_qr8`) — exact for
    rank-8 samples, elementwise ops only, in place of a batched `eigh`
    over every (9, 9) hypothesis.
  * the ONE iterative op kept is `eigh` on the single per-pair (9, 9)
    Gram matrix of the all-inlier refit (`_eight_point` + `_solve_gram`),
    where the system is genuinely least-squares (rank > 8) and the batch
    is tiny.  Hartley normalisation — applied as an exact congruence on
    the Gram matrix — buys f32 eigh ~2 extra digits there.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

DIST_THRESH = 50.0  # cv::recoverPose triangulated-distance cutoff


# ---------------------------------------------------------------------------
# closed-form / fixed-sweep linear algebra
# ---------------------------------------------------------------------------


def _jacobi_rotation(A, V, p: int, q: int):
    """One batched Jacobi rotation zeroing A[..., p, q] (symmetric A).

    The update is expressed as dense Givens products ``G^T A G`` / ``V G``
    rather than `.at[].set()` column writes, so the 90 rotations per
    eigensolve fuse into elementwise 3x3 einsums instead of one
    dynamic-update-slice each.
    """
    app = A[..., p, p]
    aqq = A[..., q, q]
    apq = A[..., p, q]
    # algebraic Givens parameters (Golub & Van Loan 8.4): no arctan2/sin/
    # cos transcendentals
    nz = jnp.abs(apq) > 1e-30
    tau = (aqq - app) / (2.0 * jnp.where(nz, apq, 1.0))
    t = -jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    # sign(0) = 0 would freeze the |tau|=0 case; pick a root there
    # (t sign matches this file's G layout: G[p,q] = -s, G[q,p] = s)
    t = jnp.where(tau == 0, 1.0, t)
    t = jnp.where(nz, t, 0.0)
    c = jax.lax.rsqrt(1.0 + t * t)
    s = t * c
    one = jnp.ones_like(c)
    zero = jnp.zeros_like(c)
    # G = I with G[p,p]=c, G[q,q]=c, G[p,q]=-s, G[q,p]=s (p, q static)
    rows = []
    for i in range(3):
        row = []
        for j in range(3):
            if i == j:
                row.append(c if i in (p, q) else one)
            elif (i, j) == (p, q):
                row.append(-s)
            elif (i, j) == (q, p):
                row.append(s)
            else:
                row.append(zero)
        rows.append(jnp.stack(row, axis=-1))
    G = jnp.stack(rows, axis=-2)
    hp = jax.lax.Precision.HIGHEST
    A = jnp.einsum("...ji,...jk,...kl->...il", G, A, G, precision=hp)
    V = jnp.einsum("...ij,...jk->...ik", V, G, precision=hp)
    return A, V


def _sym3x3_jacobi(S, sweeps: int = 5):
    """Eigendecomposition of symmetric (..., 3, 3): returns (w, V) with
    eigenvalues DESCENDING and V's columns the matching eigenvectors."""
    A = S
    V = jnp.broadcast_to(jnp.eye(3, dtype=S.dtype), S.shape)
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            A, V = _jacobi_rotation(A, V, p, q)
    w = jnp.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], axis=-1)
    order = jnp.argsort(-w, axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    V = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    return w, V


def _cross(a, b):
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def _det3x3(M):
    return jnp.sum(
        _cross(M[..., :, 0], M[..., :, 1]) * M[..., :, 2], axis=-1
    )


def _svd3x3(E, eps: float = 1e-20):
    """SVD of (..., 3, 3) via the symmetric eigenproblem of E^T E.

    Returns (U, s, V) with singular values descending, U/V proper for the
    essential-matrix use cases (the smallest singular vector pair is
    completed by cross products, so U, V are always orthogonal even when
    s2 ~ 0 — exactly the degenerate direction essential matrices live in).
    """
    hp = jax.lax.Precision.HIGHEST
    w, V = _sym3x3_jacobi(
        jnp.einsum("...ji,...jk->...ik", E, E, precision=hp)
    )
    s = jnp.sqrt(jnp.clip(w, 0.0))
    EV = jnp.einsum("...ij,...jk->...ik", E, V, precision=hp)
    u0 = EV[..., :, 0] / jnp.maximum(s[..., 0:1], eps)
    u1 = EV[..., :, 1] / jnp.maximum(s[..., 1:2], eps)
    # orthonormalise u1 against u0 (guards tiny s1), complete with cross
    u1 = u1 - jnp.sum(u0 * u1, axis=-1, keepdims=True) * u0
    u1 = u1 / jnp.maximum(
        jnp.linalg.norm(u1, axis=-1, keepdims=True), eps
    )
    u2 = _cross(u0, u1)
    U = jnp.stack([u0, u1, u2], axis=-1)
    # keep V's third column consistent: v2 = v0 x v1 (proper rotation-ish)
    v2 = _cross(V[..., :, 0], V[..., :, 1])
    V = jnp.concatenate([V[..., :, :2], v2[..., :, None]], axis=-1)
    return U, s, V


@functools.partial(jax.jit, inline=True)
def sampson_distance(E, p1, p2):
    """Squared Sampson distance for (..., 3, 3) E against (N, 2) normalised
    points; broadcasts E's leading axes -> (..., N)."""
    x1 = jnp.concatenate([p1, jnp.ones_like(p1[:, :1])], axis=1)  # (N, 3)
    x2 = jnp.concatenate([p2, jnp.ones_like(p2[:, :1])], axis=1)
    # full f32 products: a reduced-precision default (bf16 or TF32 inputs)
    # is far too coarse for epipolar residuals compared against (px/f)^2
    hp = jax.lax.Precision.HIGHEST
    Ex1 = jnp.einsum("...ij,nj->...ni", E, x1, precision=hp)
    Etx2 = jnp.einsum("...ji,nj->...ni", E, x2, precision=hp)
    num = jnp.einsum("ni,...ni->...n", x2, Ex1, precision=hp) ** 2
    den = (
        Ex1[..., :, 0] ** 2 + Ex1[..., :, 1] ** 2
        + Etx2[..., :, 0] ** 2 + Etx2[..., :, 1] ** 2
    )
    return num / jnp.maximum(den, 1e-18)


def _hartley_T(sw, sx, sy, sxx, syy, eps=1e-12):
    """Per-batch Hartley normalisation transform from weighted moments:
    translate the centroid to the origin, scale RMS radius to sqrt(2)."""
    w = jnp.maximum(sw, eps)
    cx = sx / w
    cy = sy / w
    var = jnp.maximum((sxx + syy) / w - cx * cx - cy * cy, eps)
    s = jnp.sqrt(2.0 / var)
    z = jnp.zeros_like(s)
    o = jnp.ones_like(s)
    return jnp.stack(
        [
            jnp.stack([s, z, -s * cx], -1),
            jnp.stack([z, s, -s * cy], -1),
            jnp.stack([z, z, o], -1),
        ],
        axis=-2,
    )  # (..., 3, 3)


def _kron3(T2, T1):
    """(..., 9, 9) Kronecker product of two (..., 3, 3) blocks."""
    k = T2[..., :, None, :, None] * T1[..., None, :, None, :]
    return k.reshape(k.shape[:-4] + (9, 9))


def _design_sq(p1, p2):
    """Per-row outer products of the 8-point design matrix.

    Returns ``A2 (N, 81)`` with ``A2[n] = vec(a_n a_n^T)`` for the row
    9-vector ``a_n = x2h (x) x1h``.  Any weighted Gram matrix is then ONE
    matmul ``w @ A2`` and a minimal-sample Gram matrix is a gather + sum
    of 8 rows — no (S, N, 9) intermediate ever materialises (at S = 1024
    hypotheses that intermediate is ~600 MB of HBM traffic per solve).
    """
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    ones = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=1
    )  # (N, 9)
    return (A[:, :, None] * A[:, None, :]).reshape(-1, 81)


def _solve_gram(AtA):
    """Null direction of batched 8-point Gram matrices (..., 9, 9).

    The row 9-vector is ``x2h (x) x1h``, so Hartley normalisation (the
    classic conditioning fix for the 8-point system — centroid to origin,
    RMS radius sqrt(2)) acts on the Gram matrix as an exact congruence
    ``M AtA M^T`` with ``M = T2 (x) T1``, and the per-sample moments that
    define T1/T2 are already entries of AtA — no per-sample re-stacking of
    the design matrix.  Without this, f32 factorisations lose the null
    direction entirely (minimal-sample Gram matrices reach cond ~ 1e7).
    """
    hp = jax.lax.Precision.HIGHEST
    # weighted moments live inside AtA (column layout above)
    sw = AtA[..., 8, 8]
    T1 = _hartley_T(sw, AtA[..., 8, 6], AtA[..., 8, 7],
                    AtA[..., 6, 6], AtA[..., 7, 7])
    T2 = _hartley_T(sw, AtA[..., 2, 8], AtA[..., 5, 8],
                    AtA[..., 2, 2], AtA[..., 5, 5])
    M = _kron3(T2, T1)
    AtA_n = jnp.einsum("...ij,...jk,...lk->...il", M, AtA, M, precision=hp)
    # smallest eigenvector: XLA's eigh here — the one iterative linalg op
    # kept, because hypothesis quality at marginal RANSAC support is what
    # decides edge quality, and fixed-iteration solvers (inverse power,
    # shifted power) lose the null direction on degenerate samples.
    # Hartley conditioning above still buys f32 eigh ~2 extra digits.
    e_n = jnp.linalg.eigh(AtA_n)[1][..., :, 0]
    # back to unnormalised coordinates: a . e = (M a) . e_n => e = M^T e_n
    e = jnp.einsum("...ji,...j->...i", M, e_n, precision=hp)
    e = e / jnp.maximum(
        jnp.linalg.norm(e, axis=-1, keepdims=True), 1e-30
    )
    return e.reshape(e.shape[:-1] + (3, 3))


def _eight_point(p1, p2, weights):
    """Weighted 8-point solve -> (..., 3, 3) E candidates (unprojected).

    p1, p2: (N, 2); weights: (..., N) selecting/weighting rows.  The Gram
    matrix is ONE matmul against the precomputed outer-product rows.
    """
    A2 = _design_sq(p1, p2)
    AtA = jnp.einsum(
        "...n,nk->...k", weights, A2,
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(weights.shape[:-1] + (9, 9))
    return _solve_gram(AtA)


def _nullvec_qr8(A):
    """Exact null direction of batched (..., 8, 9) design matrices via an
    unrolled Householder QR of A^T.

    Every operation is an elementwise/broadcast op over the batch — no
    iterative eigensolver: in place of XLA's batched 9x9 ``eigh``, this
    closed form is exact for rank-8 samples and is elementwise work over
    the batch.

    Rank-deficient samples get *a* unit vector from the null space —
    the same arbitrary-direction contract a float eigh gives — and the
    garbage E they produce is voted out by RANSAC exactly as before.
    """
    M = jnp.swapaxes(A, -1, -2)                  # (..., 9, 8)
    dt = A.dtype
    eye9 = jnp.eye(9, dtype=dt)
    us = []
    for k in range(8):
        col = M[..., :, k]
        v = jnp.where(jnp.arange(9) >= k, col, jnp.zeros_like(col))
        alpha = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
        sgn = jnp.where(v[..., k:k + 1] >= 0, 1.0, -1.0).astype(dt)
        u = v + sgn * alpha * eye9[k]
        nrm = jnp.sqrt(jnp.sum(u * u, axis=-1, keepdims=True))
        # degenerate column (alpha ~ 0): fall back to the identity-like
        # reflection about e_k — keeps H orthogonal, null vector arbitrary
        u = jnp.where(nrm > 1e-20, u / jnp.maximum(nrm, 1e-20), eye9[k])
        us.append(u)
        proj = jnp.einsum("...i,...ij->...j", u, M,
                          precision=jax.lax.Precision.HIGHEST)
        M = M - 2.0 * u[..., :, None] * proj[..., None, :]
    # null vector = Q e9 = H1 H2 ... H8 e9 (Q's 9th column)
    e = jnp.broadcast_to(eye9[8], us[0].shape)
    for u in reversed(us):
        e = e - 2.0 * u * jnp.sum(u * e, axis=-1, keepdims=True)
    return e


def _eight_point_samples(p1, p2, idx):
    """Minimal-sample 8-point solve for ``idx (S, 8)`` index draws.

    Gathers the 8 correspondences per sample, Hartley-normalises them
    per sample (centroid to origin, RMS radius sqrt(2) — same
    conditioning contract as `_solve_gram`), and extracts the null
    direction of the 8x9 design by the closed-form Householder QR above.
    Returns (..., 3, 3) E candidates (unprojected, unnormalised coords).
    """
    hp = jax.lax.Precision.HIGHEST
    q1 = p1[idx]                                  # (S, 8, 2)
    q2 = p2[idx]

    def norm_pts(q):
        c = jnp.mean(q, axis=-2, keepdims=True)
        var = jnp.mean(jnp.sum((q - c) ** 2, axis=-1), axis=-1)
        s = jnp.sqrt(2.0 / jnp.maximum(var, 1e-12))[..., None, None]
        return (q - c) * s, c[..., 0, :], s[..., 0, 0]

    q1n, c1, s1 = norm_pts(q1)
    q2n, c2, s2 = norm_pts(q2)
    x1, y1 = q1n[..., 0], q1n[..., 1]
    x2, y2 = q2n[..., 0], q2n[..., 1]
    rows = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
         jnp.ones_like(x1)], axis=-1)             # (S, 8, 9)
    e_n = _nullvec_qr8(rows)
    En = e_n.reshape(e_n.shape[:-1] + (3, 3))
    # denormalise: x2h'^T En x1h' = x2h^T (T2^T En T1) x1h
    def T_of(c, s):
        z = jnp.zeros_like(s)
        o = jnp.ones_like(s)
        return jnp.stack([
            jnp.stack([s, z, -s * c[..., 0]], -1),
            jnp.stack([z, s, -s * c[..., 1]], -1),
            jnp.stack([z, z, o], -1),
        ], axis=-2)
    T1 = T_of(c1, s1)
    T2 = T_of(c2, s2)
    E = jnp.einsum("...ji,...jk,...kl->...il", T2, En, T1, precision=hp)
    nrm = jnp.sqrt(jnp.sum(E * E, axis=(-2, -1), keepdims=True))
    return E / jnp.maximum(nrm, 1e-30)


def _homography_samples(p1, p2, idx):
    """Minimal 4-point DLT homographies for ``idx (S, 4)`` index draws.

    Same construction discipline as `_eight_point_samples`: gather, Hartley-
    normalise per sample, null vector of the (8, 9) design via the
    closed-form Householder QR, denormalise.  Returns (..., 3, 3) H with
    ``x2h ~ H x1h`` in normalised camera coordinates.
    """
    q1 = p1[idx]                                  # (S, 4, 2)
    q2 = p2[idx]

    def norm_pts(q):
        c = jnp.mean(q, axis=-2, keepdims=True)
        var = jnp.mean(jnp.sum((q - c) ** 2, axis=-1), axis=-1)
        s = jnp.sqrt(2.0 / jnp.maximum(var, 1e-12))[..., None, None]
        return (q - c) * s, c[..., 0, :], s[..., 0, 0]

    q1n, c1, s1 = norm_pts(q1)
    q2n, c2, s2 = norm_pts(q2)
    x1, y1 = q1n[..., 0], q1n[..., 1]
    x2, y2 = q2n[..., 0], q2n[..., 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    ra = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=-1)
    rb = jnp.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], axis=-1)
    A = jnp.concatenate([ra, rb], axis=-2)        # (S, 8, 9)
    h = _nullvec_qr8(A)
    Hn = h.reshape(h.shape[:-1] + (3, 3))

    # denormalise: x2h ~ T2^-1 Hn T1 x1h
    def T_of(c, s):
        zz = jnp.zeros_like(s)
        oo = jnp.ones_like(s)
        return jnp.stack([
            jnp.stack([s, zz, -s * c[..., 0]], -1),
            jnp.stack([zz, s, -s * c[..., 1]], -1),
            jnp.stack([zz, zz, oo], -1),
        ], axis=-2)

    def T_inv_of(c, s):
        zz = jnp.zeros_like(s)
        oo = jnp.ones_like(s)
        si = 1.0 / s
        return jnp.stack([
            jnp.stack([si, zz, c[..., 0]], -1),
            jnp.stack([zz, si, c[..., 1]], -1),
            jnp.stack([zz, zz, oo], -1),
        ], axis=-2)

    hp = jax.lax.Precision.HIGHEST
    H = jnp.einsum("...ij,...jk,...kl->...il", T_inv_of(c2, s2), Hn,
                   T_of(c1, s1), precision=hp)
    nrm = jnp.sqrt(jnp.sum(H * H, axis=(-2, -1), keepdims=True))
    return H / jnp.maximum(nrm, 1e-30)


def _homography_ls(p1, p2, w):
    """Weighted least-squares homography over all N correspondences.

    ``w (N,)`` weights (the RANSAC inlier mask); Hartley-normalises with
    the weighted moments, solves the 9x9 Gram eigenproblem, denormalises.
    This is the accuracy step a minimal 4-point H lacks: the decomposed
    motion inherits the fit's noise, so decomposition must run on an
    all-inlier fit, not a minimal sample.
    """
    hp = jax.lax.Precision.HIGHEST
    sw = jnp.maximum(jnp.sum(w), 1e-12)

    def norm_pts(q):
        c = jnp.einsum("n,nk->k", w, q, precision=hp) / sw
        d = q - c
        var = jnp.einsum("n,n->", w, jnp.sum(d * d, axis=-1),
                         precision=hp) / sw
        s = jnp.sqrt(2.0 / jnp.maximum(var, 1e-12))
        return d * s, c, s

    q1, c1, s1 = norm_pts(p1)
    q2, c2, s2 = norm_pts(p2)
    x1, y1 = q1[:, 0], q1[:, 1]
    x2, y2 = q2[:, 0], q2[:, 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    ra = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=-1)
    rb = jnp.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], axis=-1)
    AtA = (jnp.einsum("ni,n,nj->ij", ra, w, ra, precision=hp)
           + jnp.einsum("ni,n,nj->ij", rb, w, rb, precision=hp))
    h = jnp.linalg.eigh(AtA)[1][..., :, 0]
    Hn = h.reshape(3, 3)
    si1 = jnp.stack([
        jnp.stack([s1, z[0], -s1 * c1[0]], -1),
        jnp.stack([z[0], s1, -s1 * c1[1]], -1),
        jnp.stack([z[0], z[0], o[0]], -1),
    ], axis=-2)
    si2inv = jnp.stack([
        jnp.stack([1.0 / s2, z[0], c2[0]], -1),
        jnp.stack([z[0], 1.0 / s2, c2[1]], -1),
        jnp.stack([z[0], z[0], o[0]], -1),
    ], axis=-2)
    H = jnp.einsum("ij,jk,kl->il", si2inv, Hn, si1, precision=hp)
    nrm = jnp.sqrt(jnp.sum(H * H))
    return H / jnp.maximum(nrm, 1e-30)


def _transfer_inliers(H, p1, p2, valid, th2):
    """Forward-transfer inlier mask per homography: ``|Hx1/z − x2|² < th2``."""
    hp = jax.lax.Precision.HIGHEST
    x1h = jnp.concatenate([p1, jnp.ones_like(p1[:, :1])], axis=1)  # (N, 3)
    y = jnp.einsum("...ij,nj->...ni", H, x1h, precision=hp)        # (..., N, 3)
    zok = jnp.abs(y[..., 2]) > 1e-8
    zsafe = jnp.where(zok, y[..., 2], 1.0)
    e = y[..., :2] / zsafe[..., None] - p2
    d2 = jnp.sum(e * e, axis=-1)
    return zok & (d2 < th2) & valid


def _transfer_support(H, p1, p2, valid, th2):
    return jnp.sum(_transfer_inliers(H, p1, p2, valid, th2), axis=-1)


def _decompose_homography(H):
    """Faugeras-Lustman decomposition of a calibrated homography
    ``H ~ R + t n^T / d`` into its 8 (R, t) motion hypotheses.

    Returns (Rs (8, ..., 3, 3), ts (8, ..., 3)).  The physically correct
    hypothesis is selected downstream by Sampson support + cheirality —
    the same voting every other candidate goes through.  Degenerate
    spectra (d1 ~ d2 ~ d3, pure rotation: translation direction
    unobservable) come back with t ~ 0 and lose the vote naturally.
    """
    hp = jax.lax.Precision.HIGHEST
    # _svd3x3 completes U and V to PROPER rotations (cross products), so
    # the implicit third diagonal of U^T H V carries sign(det H).  The
    # Faugeras formulas assume all-nonnegative singular values; flip H's
    # sign first (H is only defined up to scale, and E = [t]x R is
    # invariant to it) so that convention holds.
    H = H * jnp.where(_det3x3(H) < 0, -1.0, 1.0)[..., None, None]
    U, d, V = _svd3x3(H)
    s = _det3x3(U) * _det3x3(V)
    d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2]
    d2s = jnp.where(jnp.abs(d2) > 1e-12, d2, 1.0)
    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-24)
    x1a = jnp.sqrt(jnp.clip((d1 * d1 - d2 * d2) / denom, 0.0))
    x3a = jnp.sqrt(jnp.clip((d2 * d2 - d3 * d3) / denom, 0.0))

    Rs, ts = [], []
    zero = jnp.zeros_like(d1)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1 = e1 * x1a
            x3 = e3 * x3a
            # case d' = +d2
            st = (d1 - d3) * x1 * x3 / d2s
            ct = (d1 * x3 * x3 + d3 * x1 * x1) / d2s
            Rp = jnp.stack([
                jnp.stack([ct, zero, -st], -1),
                jnp.stack([zero, jnp.ones_like(ct), zero], -1),
                jnp.stack([st, zero, ct], -1),
            ], axis=-2)
            tp = jnp.stack([(d1 - d3) * x1, zero, -(d1 - d3) * x3], -1)
            # case d' = -d2
            sf = (d1 + d3) * x1 * x3 / d2s
            cf = (d3 * x1 * x1 - d1 * x3 * x3) / d2s
            Rm = jnp.stack([
                jnp.stack([cf, zero, sf], -1),
                jnp.stack([zero, -jnp.ones_like(cf), zero], -1),
                jnp.stack([sf, zero, -cf], -1),
            ], axis=-2)
            tm = jnp.stack([(d1 + d3) * x1, zero, (d1 + d3) * x3], -1)
            for Rp_, tp_ in ((Rp, tp), (Rm, tm)):
                R = s[..., None, None] * jnp.einsum(
                    "...ij,...jk,...lk->...il", U, Rp_, V, precision=hp
                )
                t = jnp.einsum("...ij,...j->...i", U, tp_, precision=hp)
                tn = t / jnp.maximum(
                    jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-12
                )
                Rs.append(R)
                ts.append(tn)
    return jnp.stack(Rs), jnp.stack(ts)


def _skew(t):
    z = jnp.zeros_like(t[..., 0])
    return jnp.stack([
        jnp.stack([z, -t[..., 2], t[..., 1]], -1),
        jnp.stack([t[..., 2], z, -t[..., 0]], -1),
        jnp.stack([-t[..., 1], t[..., 0], z], -1),
    ], axis=-2)


def _project_essential(E):
    """Nearest essential matrix: singular values -> (1, 1, 0)."""
    U, s, Vt = _svd3x3(E)
    # U diag(1,1,0) V^T = u0 v0^T + u1 v1^T
    return (
        U[..., :, 0:1] * Vt[..., :, 0:1].swapaxes(-2, -1)
        + U[..., :, 1:2] * Vt[..., :, 1:2].swapaxes(-2, -1)
    )


def _cheirality_counts(E, p1, p2, inl):
    """Best-branch cheirality count for batched E (..., 3, 3) against the
    per-candidate Sampson inlier masks ``inl (..., N)``."""
    U, _, V = _svd3x3(E)
    Vt = V.swapaxes(-2, -1)
    U = U * jnp.sign(_det3x3(U))[..., None, None]
    Vt = Vt * jnp.sign(_det3x3(Vt))[..., None, None]
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                    E.dtype)
    hp = jax.lax.Precision.HIGHEST
    Ra = jnp.einsum("...ij,jk,...kl->...il", U, W, Vt, precision=hp)
    Rb = jnp.einsum("...ij,kj,...kl->...il", U, W, Vt, precision=hp)
    tu = U[..., :, 2]
    Rs = jnp.stack([Ra, Ra, Rb, Rb], axis=-3)          # (..., 4, 3, 3)
    ts = jnp.stack([tu, -tu, tu, -tu], axis=-2)        # (..., 4, 3)
    z1, z2, dist = _ray_depths(Rs, ts, p1, p2)         # (..., 4, N)
    good = ((z1 > 0) & (z2 > 0) & (dist < DIST_THRESH)
            & inl[..., None, :])
    return jnp.max(jnp.sum(good, axis=-1), axis=-1)    # (...,)


@functools.partial(
    jax.jit, static_argnames=("n_samples", "rerank_k", "h_samples"),
    inline=True
)
def ransac_essential(p1, p2, valid, key, *, th_norm, n_samples=1024,
                     E_seed=None, rerank_k=48, h_samples=192):
    """RANSAC essential matrix from (N, 2) normalised correspondences.

    Returns (E (3,3), inlier_mask (N,), n_inliers).  ``th_norm`` is the
    Sampson threshold in normalised coords (pixel_th / focal).

    Model selection is cheirality-aware: the top ``rerank_k`` candidates
    by Sampson count are re-ranked by their best-branch cheirality count.
    At small baselines the Sampson residual cannot distinguish
    translation directions — many E's fit the correspondences equally —
    so selecting on triangulated-depth support is what pins t (and with
    it R) to the physical solution.  OpenCV only cheirality-tests the
    single winner; the closed-form two-ray depth solve makes testing a
    whole candidate slate affordable.

    **Homography rescue** (``h_samples`` > 0): plane-dominated scenes are
    the known failure mode of minimal 8-point sampling — coplanar
    correspondences satisfy a 3-parameter family ``{[v]x H}`` of epipolar
    models, and with realistic noise *no* minimal sample lands near the
    true motion (measured on the synthetic benchmark: best of 300
    all-inlier samples explained 102/211 matches, while the true model
    explains 160; the reference's adaptive 5-point,
    cv::findEssentialMat at src/ViewGraph.cpp:629, enforces the
    essential structure inside its solver and is immune).  Instead of a
    5-point polynomial solver (10th-degree root finding — hostile to
    batched execution), a parallel 4-point homography RANSAC runs on
    the same draws, and the best H's Faugeras decomposition contributes
    its 8 motion hypotheses ``E = [t]x R`` to the candidate pool: for a
    plane-induced H these contain the *exact* camera motion, and the
    off-plane correspondences then select it through the ordinary
    Sampson + cheirality vote.  On non-planar scenes the H-derived
    candidates simply lose that vote — no behaviour change.

    ``E_seed`` (optional (3, 3)) joins the hypothesis pool as one more
    candidate — refinement loops may pass their current model so a
    reduced sample budget cannot regress below it.
    """
    # S minimal samples of 8 correspondences, uniform over the valid set:
    # draw ranks in [0, n_valid) and map through the cumulative count
    # (equivalent to a masked categorical draw without materialising the
    # (S, 8, N) gumbel tensor)
    cs = jnp.cumsum(valid.astype(jnp.int32))
    nv = jnp.maximum(cs[-1], 1)
    ranks = jax.random.randint(key, (n_samples, 8), 0, nv)
    # rank -> position: count of cumsum entries <= rank.  One dense
    # compare-reduce (S*8 x N) instead of jnp.searchsorted, whose
    # binary-search while_loop + scatter lowering is serial work.
    idx = jnp.sum(cs[None, None, :] <= ranks[..., None], axis=-1)

    E_cand = _eight_point_samples(p1, p2, idx)  # (S, 3, 3)
    E_cand = _project_essential(E_cand)
    if E_seed is not None:
        E_cand = jnp.concatenate([E_cand, E_seed[None]], axis=0)
    th2 = th_norm * th_norm

    if h_samples:
        # homography rescue: 4-point H RANSAC -> best H -> 8 Faugeras
        # motion hypotheses as extra E candidates (see docstring)
        ranks_h = jax.random.randint(
            jax.random.fold_in(key, 1), (h_samples, 4), 0, nv
        )
        idx_h = jnp.sum(cs[None, None, :] <= ranks_h[..., None], axis=-1)
        Hc = _homography_samples(p1, p2, idx_h)
        sup_h = _transfer_support(Hc, p1, p2, valid[None, :], 4.0 * th2)
        H_best = Hc[jnp.argmax(sup_h)]
        # decompose an all-inlier LS refit, not the minimal sample: the
        # motion hypotheses inherit the H fit's noise directly (a 4-point
        # H decomposed to ~5 deg R error on the benchmark; the ~100-point
        # refit to ~0.3 deg).  Keep the refit only if support holds.
        hinl = _transfer_inliers(H_best, p1, p2, valid, 4.0 * th2)
        H_ref = _homography_ls(p1, p2, hinl.astype(p1.dtype))
        sup_ref = _transfer_support(H_ref, p1, p2, valid, 4.0 * th2)
        H_use = jnp.where(sup_ref >= jnp.max(sup_h), H_ref, H_best)
        Rh, th_ = _decompose_homography(H_use)           # (8,3,3), (8,3)
        E_h = _project_essential(
            jnp.einsum("...ij,...jk->...ik", _skew(th_), Rh,
                       precision=jax.lax.Precision.HIGHEST)
        )
        E_cand = jnp.concatenate([E_cand, E_h], axis=0)

    d = sampson_distance(E_cand, p1, p2)        # (S, N)
    inl = (d < th2) & valid[None, :]
    scores = jnp.sum(inl, axis=1)

    # cheirality-aware re-rank of the Sampson top-k
    _, top = jax.lax.top_k(scores, rerank_k)
    che = _cheirality_counts(E_cand[top], p1, p2, inl[top])
    best = top[jnp.argmax(che)]

    # refit on the best sample's inliers (least squares over all inliers)
    best_inl = inl[best].astype(p1.dtype)
    E_ref = _project_essential(_eight_point(p1, p2, best_inl))
    d_ref = sampson_distance(E_ref, p1, p2)
    inl_ref = (d_ref < th2) & valid
    # keep the refit only if it does not lose cheirality support
    che_ref = _cheirality_counts(E_ref, p1, p2, inl_ref)
    better = che_ref >= jnp.max(che)
    E_out = jnp.where(better, E_ref, E_cand[best])
    inl_out = jnp.where(better, inl_ref, inl[best])
    return E_out, inl_out, jnp.sum(inl_out)


def _ray_depths(R, t, p1, p2):
    """Closed-form two-ray depths for P1=[I|0], P2=[R|t].

    Minimises ``|z1 (R x1h) - z2 x2h + t|`` per point (2x2 normal
    equations).  R: (..., 3, 3), t: (..., 3); p1, p2: (N, 2) normalised.
    Returns (z1, z2, dist1) with shape (..., N); degenerate (near-parallel)
    rays come back with negative depths so they fail cheirality.
    """
    x1h = jnp.concatenate([p1, jnp.ones_like(p1[:, :1])], axis=1)  # (N, 3)
    x2h = jnp.concatenate([p2, jnp.ones_like(p2[:, :1])], axis=1)
    hp = jax.lax.Precision.HIGHEST
    a = jnp.einsum("...ij,nj->...ni", R, x1h, precision=hp)  # (..., N, 3)
    b = jnp.broadcast_to(x2h, a.shape)
    aa = jnp.sum(a * a, axis=-1)
    bb = jnp.sum(b * b, axis=-1)
    ab = jnp.sum(a * b, axis=-1)
    at = jnp.einsum("...ni,...i->...n", a, t, precision=hp)
    bt = jnp.einsum("...ni,...i->...n", b, t, precision=hp)
    det = aa * bb - ab * ab
    good = det > 1e-12 * aa * bb
    det_safe = jnp.where(good, det, 1.0)
    z1 = (-at * bb + ab * bt) / det_safe
    z2 = (aa * bt - ab * at) / det_safe
    z1 = jnp.where(good, z1, -1.0)
    z2 = jnp.where(good, z2, -1.0)
    norm1 = jnp.sqrt(jnp.sum(x1h * x1h, axis=-1))      # (N,)
    dist1 = jnp.abs(z1) * norm1
    return z1, z2, dist1


@functools.partial(jax.jit, inline=True)
def recover_pose(E, p1, p2, inlier_mask):
    """Cheirality-checked (R, t) from E (cv::recoverPose contract).

    Returns (R, t, n_cheirality, pose_mask) with x2 ~ R x1 + t.
    """
    U, _, V = _svd3x3(E)
    Vt = V.swapaxes(-2, -1)
    # enforce proper rotations
    U = U * jnp.sign(_det3x3(U))
    Vt = Vt * jnp.sign(_det3x3(Vt))[..., None, None]
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                    E.dtype)
    hp = jax.lax.Precision.HIGHEST
    Ra = jnp.einsum("...ij,jk,...kl->...il", U, W, Vt, precision=hp)
    Rb = jnp.einsum("...ij,kj,...kl->...il", U, W, Vt, precision=hp)
    tu = U[..., :, 2]
    Rs = jnp.stack([Ra, Ra, Rb, Rb])           # (4, 3, 3)
    ts = jnp.stack([tu, -tu, tu, -tu])          # (4, 3)

    z1, z2, dist = _ray_depths(Rs, ts, p1, p2)  # (4, N)
    good = (
        (z1 > 0) & (z2 > 0) & (dist < DIST_THRESH) & inlier_mask[None, :]
    )
    counts = jnp.sum(good, axis=1)
    k = jnp.argmax(counts)
    return Rs[k], ts[k], counts[k], good[k]
