"""Independent NumPy/SciPy oracles for the rotation-averaging solvers and
the descriptor matcher.

This is a from-the-math transcription of the MATLAB algorithms that the
reference C++ inlines as comments (l1-magic's l1decode_pd; the IRLS weight
table).  It deliberately uses a different numerical stack (scipy.sparse
direct solves) than both the C++ (SuiteSparse) and the JAX implementation,
so agreement between this oracle and irotavg_tpu is strong evidence of
algorithmic fidelity.  Used by the tests and by chip_smoke.py.
"""

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def qmul(q1, q2):
    q1 = np.atleast_2d(q1)
    q2 = np.atleast_2d(q2)
    x1, y1, z1, w1 = q1[:, 0], q1[:, 1], q1[:, 2], q1[:, 3]
    x2, y2, z2, w2 = q2[:, 0], q2[:, 1], q2[:, 2], q2[:, 3]
    return np.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=1,
    )


def delta_rel(edges, QQ, Q):
    Qi = Q[edges[:, 0]]
    Qj_inv = Q[edges[:, 1]].copy()
    Qj_inv[:, 3] *= -1
    return qmul(Qj_inv, qmul(QQ, Qi))


EPS = 2.2204e-16


def log_map(q):
    q = np.array(q, float)
    s2 = np.linalg.norm(q[:, :3], axis=1)
    theta = 2 * np.arctan2(s2, q[:, 3])
    theta = np.where(theta < -np.pi, theta + 2 * np.pi, theta)
    theta = np.where(theta >= np.pi, theta - 2 * np.pi, theta)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = theta / s2
    out = q.copy()
    out[:, :3] *= scale[:, None]
    out[:, 3] = theta
    out[s2 < EPS, :3] = 0
    return out


def exp_map(v):
    v = np.array(v, float)[:, :3]
    theta = np.linalg.norm(v, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        coef = np.sin(theta / 2) / theta
    coef = np.where(np.isfinite(coef), coef, 0.0)
    return np.concatenate(
        [v * coef[:, None], np.cos(theta / 2)[:, None]], axis=1
    )


def make_A(n, f, edges):
    m = len(edges)
    rows, cols, vals = [], [], []
    for k, (i, j) in enumerate(edges):
        jj = j - f
        if jj < 0:
            continue
        rows.append(k), cols.append(jj), vals.append(1.0)
        ii = i - f
        if ii < 0:
            continue
        rows.append(k), cols.append(ii), vals.append(-1.0)
    return sp.csc_matrix((vals, (rows, cols)), shape=(m, n - f))


def l1decode_pd(x0, A, y, pdmaxiter):
    PDTOL, alpha, beta, mu = 1e-3, 0.01, 0.5, 10.0
    n, m = len(x0), len(y)
    x = x0.copy()
    Ax = A @ x
    ra = np.abs(y - Ax)
    u = 0.95 * ra + 0.10 * ra.max()
    fu1 = Ax - y - u
    fu2 = -Ax + y - u
    lamu1 = -1.0 / fu1
    lamu2 = -1.0 / fu2
    Atv = A.T @ (lamu1 - lamu2)
    sdg = -(fu1 @ lamu1 + fu2 @ lamu2)
    tau = mu * 2 * m / sdg
    rdual = np.concatenate([Atv, 1.0 - lamu1 - lamu2])
    rcent = np.concatenate([-lamu1 * fu1, -lamu2 * fu2]) - 1.0 / tau
    resnorm = np.sqrt(rdual @ rdual + rcent @ rcent)

    pditer = 0
    xp = x
    while not (sdg < PDTOL or pditer >= pdmaxiter):
        pditer += 1
        w2 = -1 - 1.0 / tau * (1 / fu1 + 1 / fu2)
        sig1 = -lamu1 / fu1 - lamu2 / fu2
        sig2 = lamu1 / fu1 - lamu2 / fu2
        sigx = sig1 - sig2**2 / sig1
        w1 = -1.0 / tau * (A.T @ (-1 / fu1 + 1 / fu2))
        w1p = w1 - A.T @ ((sig2 / sig1) * w2)
        H11p = (A.T @ sp.diags(sigx) @ A).tocsc()
        dx = spla.spsolve(H11p, w1p)
        Adx = A @ dx
        du = (w2 - sig2 * Adx) / sig1
        dlamu1 = -(lamu1 / fu1) * (Adx - du) - lamu1 - (1 / tau) / fu1
        dlamu2 = (lamu2 / fu2) * (Adx + du) - lamu2 - (1 / tau) / fu2
        Atdv = A.T @ (dlamu1 - dlamu2)

        s = 1.0
        ind = dlamu1 < 0
        if ind.any():
            s = min(s, (-lamu1[ind] / dlamu1[ind]).min())
        ind = dlamu2 < 0
        if ind.any():
            s = min(s, (-lamu2[ind] / dlamu2[ind]).min())
        ind = (Adx - du) > 0
        if ind.any():
            s = min(s, (-fu1[ind] / (Adx[ind] - du[ind])).min())
        ind = (-Adx - du) > 0
        if ind.any():
            s = min(s, (-fu2[ind] / (-Adx[ind] - du[ind])).min())
        s *= 0.99

        suffdec = False
        backiter = 0
        while not suffdec:
            xp = x + s * dx
            up = u + s * du
            Axp = Ax + s * Adx
            Atvp = Atv + s * Atdv
            lamu1p = lamu1 + s * dlamu1
            lamu2p = lamu2 + s * dlamu2
            fu1p = Axp - y - up
            fu2p = -Axp + y - up
            rdp = np.concatenate([Atvp, 1.0 - lamu1p - lamu2p])
            rcp = np.concatenate([-lamu1p * fu1p, -lamu2p * fu2p]) - 1.0 / tau
            suffdec = np.sqrt(rdp @ rdp + rcp @ rcp) <= (1 - alpha * s) * resnorm
            s *= beta
            backiter += 1
            if backiter > 32:
                return x
        x, u, Ax, Atv = xp, up, Axp, Atvp
        lamu1, lamu2, fu1, fu2 = lamu1p, lamu2p, fu1p, fu2p
        sdg = -(fu1 @ lamu1 + fu2 @ lamu2)
        tau = mu * 2 * m / sdg
        rcent = np.concatenate([-lamu1 * fu1, -lamu2 * fu2]) - 1.0 / tau
        rdual = rdp
        resnorm = np.sqrt(rdual @ rdual + rcent @ rcent)
    return xp


def l1ra(QQ, edges, A, Q, f, max_iters, change_th):
    Q = Q.copy()
    n = Q.shape[0] - f
    score = np.inf
    it = 0
    while score >= change_th and it < max_iters:
        w = log_map(delta_rel(edges, QQ, Q))
        W = np.zeros((n, 4))
        for c in range(3):
            W[:, c] = l1decode_pd(np.zeros(n), A, w[:, c], 2)
        score = np.linalg.norm(W[:, :3], axis=1).mean()
        Wq = exp_map(W)
        Q[f:] = qmul(Q[f:], Wq)
        it += 1
    return Q, it, score


def irls_weights(cost, E, weights, sigma):
    e2 = np.sum(E**2, axis=1)
    en = np.sqrt(e2)
    w = weights.copy()
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if cost == "L2":
            pass
        elif cost == "L0.5":
            w = np.minimum(e2 ** (-3.0 / 8.0), 1e4)
        elif cost == "L1":
            w = np.minimum(en ** (-0.5), 1e4)
        elif cost == "L1.5":
            w = np.minimum(en ** (-0.25), 1e4)
        elif cost == "Geman-McClure":
            w = 1.0 / (e2 + sigma**2)
        elif cost == "Huber":
            t = 1.345 * sigma
            e = en / t
            w = np.where(e >= 1, np.sqrt(1.0 / e), weights)
        elif cost == "Pseudo-Huber":
            w = (1 + e2 / sigma**2) ** (-0.25)
        elif cost == "Andrews":
            t = 1.339 * sigma
            e = en / t
            w = np.sqrt(np.sin(e) / e)
            w[e >= np.pi] = 0
            w[e < 1e-4] = 1
            w = np.maximum(w, 1e-4)
        elif cost == "Bisquare":
            t = 4.685 * sigma
            w = np.maximum(1 - e2 / t**2, 1e-4)
        elif cost == "Cauchy":
            t = 2.385 * sigma
            w = (1 + e2 / t**2) ** (-0.5)
        elif cost == "Fair":
            t = 1.400 * sigma
            w = (1 + en / t) ** (-0.5)
        elif cost == "Logistic":
            t = 1.205 * sigma
            e = en / t
            w = np.sqrt(np.tanh(e) / e)
            w[e < 1e-4] = 1
        elif cost == "Talwar":
            t = 2.795 * sigma
            w = np.where(e2 < t**2, 1.0001, 0.0)
        elif cost == "Welsch":
            t = 2.985 * sigma
            w = np.maximum(np.exp(-0.5 * e2 / t**2), 1e-4)
        else:
            raise ValueError(cost)
    return w


def irls(QQ, edges, A, cost, sigma, Q, f, max_iters, change_th):
    Q = Q.copy()
    m = QQ.shape[0]
    weights = np.ones(m)
    score = np.inf
    it = 0
    while score > change_th and it < max_iters:
        w = log_map(delta_rel(edges, QQ, Q))
        DA = sp.diags(weights) @ A
        DB = weights[:, None] * w[:, :3]
        # least squares via normal equations (scipy lacks sparse QR);
        # float64 + tiny graphs in tests keep this accurate enough
        G = (DA.T @ DA).tocsc()
        W3 = spla.spsolve(G, DA.T @ DB)
        W3 = np.asarray(W3).reshape(-1, 3)
        E = A @ W3 - w[:, :3]
        weights = irls_weights(cost, E, weights, sigma)
        score = np.linalg.norm(W3, axis=1).mean()
        W = exp_map(np.concatenate([W3, np.zeros((len(W3), 1))], axis=1))
        Q[f:] = qmul(Q[f:], W)
        it += 1
    return Q, weights, it, score


def best2(gate, d1, d2, rowf, colft, big=10_000.0):
    """Gated best/second-best Hamming match by XOR + popcount over the 8
    descriptor words, with the gate rules of ``ops/hamming.gate_mask``
    written out in f32 numpy.  Returns (d1, d2, idx) like ``best2``."""
    D = np.bitwise_count(d1[:, None, :] ^ d2[None, :, :]).sum(-1)
    r = [np.asarray(rowf, np.float32)[:, k:k + 1] for k in range(8)]
    c = [np.asarray(colft, np.float32)[k:k + 1, :] for k in range(8)]
    mask = (r[0] > 0) & (c[0] > 0)
    if gate in ("node", "epipolar"):
        mask &= r[1] == c[1]
    if gate == "local":
        mask &= (np.abs(c[2] - r[2]) <= r[5]) & (np.abs(c[3] - r[3]) <= r[5])
        mask &= (c[4] >= np.maximum(r[4] - 2, 0)) & \
                (c[4] <= np.minimum(r[4] + 2, 7))
    if gate.startswith("epipolar"):
        num = c[5] * r[2] + c[6] * r[3] + c[7]
        mask &= num * num < r[5] * (c[5] * c[5] + c[6] * c[6])
    Dm = np.where(mask, D, big).astype(np.float32)
    n1 = len(d1)
    if Dm.shape[1] == 0:
        return np.full(n1, big), np.full(n1, big), np.full(n1, -1)
    rows = np.arange(n1)
    i1 = np.argmin(Dm, axis=1)
    best = Dm[rows, i1]
    Dm[rows, i1] = big
    return best, Dm.min(axis=1), np.where(best >= big, -1, i1)
