"""Single-dispatch two-view estimation loops.

The reference's `refinePose` (src/ViewGraph.cpp:725-783) and
`findInitialPose` (:828-902) are host loops alternating matching with
RANSAC — fine in-process, but each step would be a device dispatch and a
fetch here.  These fused versions run the whole alternation as one jitted
``lax.while_loop``: match (ops/hamming.best2) → essential RANSAC →
cheirality recovery → accept/stop, with all state (E, R, t, match
assignment, search radius) living on device.

Assignment-vector convention: matches are carried as ``m12: (N1,) int32``
(row -> column index or -1), never as dynamic-length pair lists, so every
shape is static.

Dispatch discipline: EVERY op executed outside jit (a ``jnp.stack`` of
device arrays, a ``jax.random.key``, a ``jnp.zeros``) is its own
dispatch.  So the fused entry points take plain ``seed`` scalars (the PRNG key is created inside
the program), accept ``None`` for absent node arrays (zeros are
materialised in-program), and `fused_refine_window` takes the window
candidates as an UNSTACKED tuple of per-frame arrays, stacking on
device inside the program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from irotavg_tpu.geometry.essential import ransac_essential, recover_pose
from irotavg_tpu.matching.matchers import (
    _match_epipolar_core, _match_locally_core,
)


def _norm_coords(x, y, cam):
    fx, fy, cx, cy = cam
    return jnp.stack([(x - cx) / fx, (y - cy) / fy], axis=1)


def _ransac_from_assignment(m12, x1, y1, x2, y2, cam, th_norm, key,
                            n_samples, E_seed=None):
    """RANSAC + cheirality over an assignment vector (rows of frame 1 ->
    columns of frame 2).  Returns (E, R, t, n_che, pose_mask)."""
    p1 = _norm_coords(x1, y1, cam)
    j = jnp.clip(m12, 0, None)
    p2 = _norm_coords(x2[j], y2[j], cam)
    vmask = m12 >= 0
    E, inl, _ = ransac_essential(p1, p2, vmask, key, th_norm=th_norm,
                                 n_samples=n_samples, E_seed=E_seed)
    R, t, n_che, pose_mask = recover_pose(E, p1, p2, inl)
    return E, R, t, n_che, pose_mask


@functools.partial(
    jax.jit,
    static_argnames=("has_nodes", "max_iters", "n_samples"),
)
def fused_refine(bits1, nodes1, valid1, angle1, x1, y1, oct1,
                 bits2t, nodes2, valid2, angle2, x2, y2,
                 E0, R0, t0, n0, m12_0,
                 K_inv, sigma2, cam, th_norm, key,
                 min_pairs, *, has_nodes, max_iters=10, n_samples=512):
    """`refinePose` as one device program.

    Loop contract (src/ViewGraph.cpp:725-783): build F from the current E,
    rematch with the epipolar gate, re-run RANSAC + cheirality, accept
    while the cheirality-inlier count strictly grows; stop when the
    rematch is too small (< min_pairs), RANSAC support <= 4, recovery
    <= 6 inliers, or no improvement.

    Each re-solve seeds the hypothesis pool with the incoming model
    (``E_seed``) so a refine iteration can never regress below it.

    Returns (E, R, t, best_n, best_m12, iters).
    """
    f32 = jnp.float32

    def cond(st):
        return (~st[0]) & (st[9] < max_iters)

    def body(st):
        _, E_cur, E, R, t, best_n, best_m12, k, stall, it = st
        # full f32 products: a reduced-precision default (bf16 or TF32
        # inputs) is too coarse for the epipolar gate fed by F
        F = jnp.einsum("ji,jk,kl->il", K_inv, E_cur.astype(f32), K_inv,
                       precision=jax.lax.Precision.HIGHEST)
        m12 = _match_epipolar_core(
            bits1, nodes1, valid1, angle1, x1, y1, oct1,
            bits2t, nodes2, valid2, angle2, x2, y2,
            F, sigma2, has_nodes=has_nodes,
        ).astype(jnp.int32)
        count = jnp.sum(m12 >= 0)
        k, sub = jax.random.split(k)
        # NO model seeding here: at small baselines the Sampson vote
        # cannot distinguish translation directions, so a seeded pool
        # locks into a self-reinforcing model that cheirality rejects —
        # fresh hypotheses + the all-inlier refit migrate t to the
        # direction the depth test accepts
        E_new, R_new, t_new, n_new, pose_mask = _ransac_from_assignment(
            m12, x1, y1, x2, y2, cam, th_norm, sub, n_samples,
        )
        usable = (count >= min_pairs) & (count > 4) & (n_new > 6)
        # improvement tracking: keep the BEST model seen, but keep
        # iterating from the newest usable model — a single unlucky
        # re-solve must not freeze the alternation (the reference's
        # stop-at-first-non-growth is robust there because OpenCV's
        # adaptive RANSAC is near-deterministic at these inlier ratios)
        improved = usable & (n_new > best_n)
        E = jnp.where(improved, E_new, E)
        R = jnp.where(improved, R_new, R)
        t = jnp.where(improved, t_new, t)
        best_n = jnp.where(improved, n_new, best_n).astype(jnp.int32)
        best_m12 = jnp.where(
            improved, jnp.where(pose_mask, m12, -1), best_m12
        )
        E_cur = jnp.where(usable, E_new, E_cur)
        # patience: allow ONE non-improving re-solve before stopping (a
        # single unlucky draw must not end the alternation, but running
        # all max_iters when converged wastes the whole batch's time)
        stall = jnp.where(improved, 0, stall + 1).astype(jnp.int32)
        done = (~usable) | (stall >= 2)
        return (done, E_cur, E, R, t, best_n, best_m12, k, stall, it + 1)

    st = (jnp.asarray(False), E0.astype(f32), E0.astype(f32), R0.astype(f32),
          t0.astype(f32), jnp.asarray(n0, jnp.int32),
          jnp.asarray(m12_0, jnp.int32), key, jnp.asarray(0, jnp.int32),
          jnp.asarray(0, jnp.int32))
    st = jax.lax.while_loop(cond, body, st)
    return st[2], st[3], st[4], st[5], st[6], st[9]


@functools.partial(
    jax.jit, static_argnames=("max_trials", "n_samples")
)
def fused_initial_pose(bits_c, valid_c, oct_c, x_c, y_c,
                       bits_pt, valid_p, oct_p, x_p, y_p,
                       local_rad0, cam, th_norm, seed,
                       min_inliers, nnratio, *, max_trials=6,
                       n_samples=512):
    """`findInitialPose`'s adaptive-radius search as one device program
    (src/ViewGraph.cpp:828-902).

    Matches current -> previous in a window of the escalating radius
    (x1.25 per retry), updates ``local_rad`` to the mean match
    displacement, and accepts once cheirality inliers exceed
    ``min_inliers`` (the caller passes 2*min_matches).  The returned
    assignment maps current-frame rows to previous-frame columns; the
    recovered pose maps previous -> current.  ``seed`` is a plain uint32
    scalar; the PRNG key is created in-program (a host-side
    ``jax.random.key`` is its own dispatch).

    Returns (E, R, t, n_che, m12, local_rad, rel_valid, accepted).
    """
    key = jax.random.key(jnp.asarray(seed, jnp.uint32))
    return _initial_pose_core(
        bits_c, valid_c, oct_c, x_c, y_c,
        bits_pt, valid_p, oct_p, x_p, y_p,
        local_rad0, cam, th_norm, key, min_inliers, nnratio,
        max_trials=max_trials, n_samples=n_samples,
    )


def _initial_pose_core(bits_c, valid_c, oct_c, x_c, y_c,
                       bits_pt, valid_p, oct_p, x_p, y_p,
                       local_rad0, cam, th_norm, key,
                       min_inliers, nnratio, *, max_trials=6,
                       n_samples=512):
    """Traced body of `fused_initial_pose` (key instead of seed), shared
    with the single-program `fused_process_frame`."""
    f32 = jnp.float32
    local_rad0 = jnp.asarray(local_rad0)

    def cond(st):
        return (~st[0]) & (st[10] < max_trials)

    def body(st):
        (_, rad, local_rad, E, R, t, n_che, m12_best, valid_rel, k,
         trial) = st[:11]
        m12 = _match_locally_core(
            bits_c, valid_c, oct_c, x_c, y_c,
            bits_pt, valid_p, oct_p, x_p, y_p,
            rad, nnratio,
        ).astype(jnp.int32)
        matched = m12 >= 0
        count = jnp.sum(matched)
        j = jnp.clip(m12, 0, None)
        disp = jnp.hypot(x_c - x_p[j], y_c - y_p[j])
        mean_disp = (jnp.sum(jnp.where(matched, disp, 0.0))
                     / jnp.maximum(count, 1)).astype(f32)
        local_rad = jnp.where(count > 0, mean_disp, local_rad)

        too_few = count <= 4
        local_rad = jnp.where(too_few, 1.0, local_rad)

        # pose: previous -> current, so frame-1 coords come via m12
        k, sub = jax.random.split(k)
        p1 = _norm_coords(x_p[j], y_p[j], cam)
        p2 = _norm_coords(x_c, y_c, cam)
        vmask = matched
        E_new, inl, _ = ransac_essential(p1, p2, vmask, sub,
                                         th_norm=th_norm,
                                         n_samples=n_samples)
        R_new, t_new, n_new, pose_mask = recover_pose(E_new, p1, p2, inl)
        rel_ok = (count > 4) & (n_new > 6)
        accepted = rel_ok & (n_new > min_inliers)

        keep = ~too_few
        E = jnp.where(keep, E_new, E)
        R = jnp.where(keep, R_new, R)
        t = jnp.where(keep, t_new, t)
        n_che = jnp.where(keep, n_new, n_che).astype(jnp.int32)
        m12_best = jnp.where(
            keep, jnp.where(accepted, jnp.where(pose_mask, m12, -1), m12),
            m12_best,
        )
        # a too-small trial keeps the previous trial's pose (host parity;
        # unreachable downstream anyway — local_rad=1 fails the keyframe
        # gate)
        valid_rel = jnp.where(keep, rel_ok, valid_rel)
        done = too_few | accepted
        return (done, rad * 1.25, local_rad, E, R, t, n_che, m12_best,
                valid_rel, k, trial + 1, accepted & ~too_few)

    n1 = bits_c.shape[0]
    st = (jnp.asarray(False), jnp.asarray(2.0, f32) * local_rad0,
          local_rad0.astype(f32), jnp.eye(3, dtype=f32),
          jnp.eye(3, dtype=f32), jnp.zeros(3, f32),
          jnp.asarray(0, jnp.int32), jnp.full((n1,), -1, jnp.int32),
          jnp.asarray(False), key, jnp.asarray(0, jnp.int32),
          jnp.asarray(False))
    st = jax.lax.while_loop(cond, body, st)
    return st[3], st[4], st[5], st[6], st[7], st[2], st[8], st[11]


@functools.partial(
    jax.jit, static_argnames=("has_nodes", "max_iters", "n_samples")
)
def fused_window_connect(bits1, nodes1, valid1, angle1, x1, y1, oct1,
                         m12_0, active,
                         bits2t, nodes2, valid2, angle2, x2, y2,
                         K_inv, sigma2, cam, th_norm, key, min_matches,
                         *, has_nodes, max_iters=10, n_samples=512):
    """The window walk's per-older-view RANSAC + refinement, batched.

    `processFrame`'s back-connection loop (src/ViewGraph.cpp:1109-1136)
    runs `findPose` (pivot-composed matches -> RANSAC) then `refinePose`
    per older view.  Here every candidate view solves concurrently in one
    device program (vmap over the leading axis); the caller walks the
    results in order and stops at the first failure, preserving the
    reference's early-break semantics.

    Batched inputs (leading axis = candidate older view): the candidate
    frames' feature arrays, composed assignments ``m12_0`` (candidate row
    -> current-frame column), and ``active`` (composed pair count > 5).
    Returns (E, R, t, n_che, m12, success) with leading axis K.
    """

    def one(bits1k, nodes1k, valid1k, angle1k, x1k, y1k, oct1k,
            m12k, activek, keyk):
        E0, R0, t0, n0, pose_mask = _ransac_from_assignment(
            m12k, x1k, y1k, x2, y2, cam, th_norm, keyk, n_samples
        )
        count0 = jnp.sum(m12k >= 0)
        rel_ok = activek & (count0 > 4) & (n0 > 6)
        m12f = jnp.where(pose_mask, m12k, -1).astype(jnp.int32)
        cntf = jnp.sum(m12f >= 0)

        keyk, sub = jax.random.split(keyk)
        E, R, t, n, m12r, _ = fused_refine(
            bits1k, nodes1k, valid1k, angle1k, x1k, y1k, oct1k,
            bits2t, nodes2, valid2, angle2, x2, y2,
            E0, R0, t0, cntf, m12f,
            K_inv, sigma2, cam, th_norm, sub,
            # same rematch-size floor refinePose applies (0.75*min_matches)
            jnp.ceil(0.75 * min_matches).astype(jnp.int32),
            # full sample budget for the from-scratch solve above; the
            # refine re-solves run at the smaller high-inlier-ratio budget
            has_nodes=has_nodes, max_iters=max_iters, n_samples=512,
        )
        do_refine = cntf > 10
        E = jnp.where(do_refine, E, E0.astype(jnp.float32))
        R = jnp.where(do_refine, R, R0.astype(jnp.float32))
        t = jnp.where(do_refine, t, t0.astype(jnp.float32))
        n = jnp.where(do_refine, n, n0).astype(jnp.int32)
        m12 = jnp.where(do_refine, m12r, m12f)
        final_cnt = jnp.sum(m12 >= 0)
        success = rel_ok & (final_cnt >= min_matches)
        return E, R, t, n, m12, success

    keys = jax.random.split(key, bits1.shape[0])
    return jax.vmap(one)(bits1, nodes1, valid1, angle1, x1, y1, oct1,
                         m12_0, active, keys)


@functools.partial(
    jax.jit, static_argnames=("max_iters", "n_samples")
)
def fused_pair_estimate(bitsA, validA, octA, xA, yA, angleA,
                        bitsBt, validB, octB, xB, yB, angleB,
                        radius, K_inv, sigma2, cam, th_norm, key,
                        min_matches, *, max_iters=10, n_samples=512):
    """Batched independent two-view estimation for arbitrary frame pairs.

    The offline/batch pipeline's core: a leading axis of P pairs, each
    with its own source (A) and target (B) features and search radius.
    Per pair: local window matching (A rows -> B columns) -> essential
    RANSAC + cheirality -> epipolar-rematch refinement — the same
    match/solve/refine contract the incremental engine applies pair-wise
    (src/ViewGraph.cpp:828-902, :725-783), but with many pairs per device
    program instead of one dispatch each.

    Returns (E, R, t, n_che, m12, success) with leading axis P, where
    success requires >= min_matches final matches and the recovered pose
    maps A -> B (edge convention ``R_B = R_AB R_A``).
    """
    return _pair_estimate_core(
        bitsA, validA, octA, xA, yA, angleA,
        bitsBt, validB, octB, xB, yB, angleB,
        radius, K_inv, sigma2, cam, th_norm, key, min_matches,
        max_iters=max_iters, n_samples=n_samples,
    )


def _pair_estimate_core(bitsA, validA, octA, xA, yA, angleA,
                        bitsBt, validB, octB, xB, yB, angleB,
                        radius, K_inv, sigma2, cam, th_norm, key,
                        min_matches, *, max_iters=10, n_samples=512):
    """Traced body of `fused_pair_estimate`, shared with the in-program
    gather wrapper above."""

    def one(bA, vA, oA, xa, ya, aA, bBt, vB, oB, xb, yb, aB, rad, k):
        m12 = _match_locally_core(
            bA, vA, oA, xa, ya, bBt, vB, oB, xb, yb, rad, 0.9
        ).astype(jnp.int32)
        count0 = jnp.sum(m12 >= 0)
        k, sub = jax.random.split(k)
        E0, R0, t0, n0, pose_mask = _ransac_from_assignment(
            m12, xa, ya, xb, yb, cam, th_norm, sub, n_samples
        )
        rel_ok = (count0 > 4) & (n0 > 6)
        m12f = jnp.where(pose_mask, m12, -1).astype(jnp.int32)
        cntf = jnp.sum(m12f >= 0)

        k, sub = jax.random.split(k)
        zeros = jnp.zeros_like(m12)
        E, R, t, n, m12r, _ = fused_refine(
            bA, zeros, vA, aA, xa, ya, oA,
            bBt, zeros, vB, aB, xb, yb,
            E0, R0, t0, cntf, m12f,
            K_inv, sigma2, cam, th_norm, sub,
            jnp.ceil(0.75 * min_matches).astype(jnp.int32),
            has_nodes=False, max_iters=max_iters, n_samples=512,
        )
        do_refine = cntf > 10
        E = jnp.where(do_refine, E, E0.astype(jnp.float32))
        R = jnp.where(do_refine, R, R0.astype(jnp.float32))
        t = jnp.where(do_refine, t, t0.astype(jnp.float32))
        n = jnp.where(do_refine, n, n0).astype(jnp.int32)
        m12 = jnp.where(do_refine, m12r, m12f)
        final_cnt = jnp.sum(m12 >= 0)
        success = rel_ok & (final_cnt >= min_matches)
        return E, R, t, n, m12, success

    keys = jax.random.split(key, bitsA.shape[0])
    return jax.vmap(one)(bitsA, validA, octA, xA, yA, angleA,
                         bitsBt, validB, octB, xB, yB, angleB,
                         radius, keys)


@functools.partial(
    jax.jit, static_argnames=("has_nodes", "n_samples")
)
def fused_refine_window(
    bits_c, nodes_c, valid_c, angle_c, x_c, y_c, oct_c,
    bits_p, nodes_p, valid_p, angle_p, x_p, y_p, oct_p,
    cands,
    m12_w2p, active_w,
    E0, R0, t0, m12_cp,
    K_inv, sigma2, cam, th_norm, seed, min_matches,
    *, has_nodes, n_samples=512,
):
    """Everything `processFrame` does AFTER the keyframe gate, as one
    program: epipolar refine of the initial pose, then the pivot-chained
    window walk (src/ViewGraph.cpp:1081-1136).

    Two-phase split rationale: the gate (local_rad < 5 px -> reject,
    :1071) is a host decision that kills ~2/3 of frames on real
    sequences, and the refine+window stages are ~3/4 of the per-frame
    device compute — fusing them WITH the initial pose would spend that
    compute speculatively on every rejected frame.  So the engine runs
    `fused_initial_pose` (one dispatch, gate decided from its
    local_rad), and accepted frames pay exactly one more dispatch for
    this program — down from the previous three per accepted frame.

    ``cands`` is an UNSTACKED tuple of per-candidate frame tuples
    ``(bits, nodes, valid, angle, x, y, octave)`` (``nodes`` may be
    ``None`` when ``has_nodes`` is False); the stack happens on device
    inside this program — a host-side ``jnp.stack`` of K x 7 device
    arrays would be ~20 separate dispatches.

    ``m12_cp`` is the initial pose's current-row -> previous-column
    assignment (the device output of `fused_initial_pose`, passed
    through without a fetch); the flip to previous -> current,
    the refine seed, and the chain composition through the *refined*
    assignment all stay on device.

    Returns ``(refined, window)``:
      refined = (E_r, R_r, t_r, n_r, m12_pc)   # prev row -> curr col
      window  = (E_w, R_w, t_w, n_w, m12_w, success_w)  # leading axis K
    """
    key = jax.random.key(jnp.asarray(seed, jnp.uint32))
    n_feat = x_c.shape[0]
    zeros = jnp.zeros((n_feat,), jnp.int32)
    if not has_nodes:
        nodes_c = nodes_p = zeros
    w_stack = _stack_candidates(cands, n_feat, has_nodes)
    return _refine_window_core(
        bits_c, nodes_c, valid_c, angle_c, x_c, y_c, oct_c,
        bits_p, nodes_p, valid_p, angle_p, x_p, y_p, oct_p,
        w_stack, m12_w2p, active_w, E0, R0, t0, m12_cp,
        K_inv, sigma2, cam, th_norm, key, min_matches,
        has_nodes=has_nodes, n_samples=n_samples,
    )


def _stack_candidates(cands, n_feat, has_nodes):
    """Stack the per-candidate frame tuples on device (inside a program)."""
    bits_w = jnp.stack([c[0] for c in cands])
    nodes_w = (jnp.stack([c[1] for c in cands]) if has_nodes
               else jnp.zeros((len(cands), n_feat), jnp.int32))
    valid_w = jnp.stack([c[2] for c in cands])
    angle_w = jnp.stack([c[3] for c in cands])
    x_w = jnp.stack([c[4] for c in cands])
    y_w = jnp.stack([c[5] for c in cands])
    oct_w = jnp.stack([c[6] for c in cands])
    return bits_w, nodes_w, valid_w, angle_w, x_w, y_w, oct_w


def _refine_window_core(
    bits_c, nodes_c, valid_c, angle_c, x_c, y_c, oct_c,
    bits_p, nodes_p, valid_p, angle_p, x_p, y_p, oct_p,
    w_stack, m12_w2p, active_w, E0, R0, t0, m12_cp,
    K_inv, sigma2, cam, th_norm, key, min_matches,
    *, has_nodes, n_samples=512,
):
    """Traced body of `fused_refine_window` (stacked candidates + key),
    shared with the single-program `fused_process_frame`."""
    bits_w, nodes_w, valid_w, angle_w, x_w, y_w, oct_w = w_stack
    # current->previous assignment flipped to previous->current (the
    # orientation refine and the pivot chain use).  Duplicate targets:
    # one writer wins, like the host's vectorised assignment did.
    n_prev = x_p.shape[0]
    n_curr = x_c.shape[0]
    rows = jnp.arange(n_curr, dtype=jnp.int32)
    matched = m12_cp >= 0
    tgt = jnp.where(matched, m12_cp, n_prev)
    m12_pc0 = (
        jnp.full((n_prev + 1,), -1, jnp.int32)
        .at[tgt].set(jnp.where(matched, rows, -1), mode="drop")[:n_prev]
    )
    cnt0 = jnp.sum(m12_pc0 >= 0)

    key, sub = jax.random.split(key)
    bits_ct = jnp.swapaxes(bits_c, 0, 1)
    E_r, R_r, t_r, n_r, m12_pc, _ = fused_refine(
        bits_p, nodes_p, valid_p, angle_p, x_p, y_p, oct_p,
        bits_ct, nodes_c, valid_c, angle_c, x_c, y_c,
        E0, R0, t0, cnt0, m12_pc0,
        K_inv, sigma2, cam, th_norm, sub,
        jnp.ceil(0.75 * min_matches).astype(jnp.int32),
        has_nodes=has_nodes, n_samples=n_samples,
    )

    # pivot chaining on device: candidate row -> pivot row -> curr col
    j = jnp.clip(m12_w2p, 0, None)
    m12_w2c = jnp.where(m12_w2p >= 0, m12_pc[j], -1).astype(jnp.int32)
    active = active_w & (jnp.sum(m12_w2c >= 0, axis=1) > 5)

    key, sub = jax.random.split(key)
    window = fused_window_connect(
        bits_w, nodes_w, valid_w, angle_w, x_w, y_w, oct_w,
        m12_w2c, active,
        bits_ct, nodes_c, valid_c, angle_c, x_c, y_c,
        K_inv, sigma2, cam, th_norm, sub, min_matches,
        has_nodes=has_nodes, n_samples=n_samples,
    )

    return (E_r, R_r, t_r, n_r, m12_pc), window


@functools.partial(
    jax.jit, static_argnames=("has_nodes", "n_samples", "max_iters")
)
def fused_bow_pair_estimate(bits1, nodes1, valid1, angle1, x1, y1, oct1,
                            bits2t, nodes2, valid2, angle2, x2, y2,
                            K_inv, sigma2, cam, th_norm, seed, nnratio,
                            min_matches, *, has_nodes, n_samples=512,
                            max_iters=10):
    """Loop-closure verification as ONE program: BoW-guided matching ->
    essential RANSAC + cheirality -> epipolar-rematch refinement.

    The contract of the app's loop-closure block (src/IRotAvg.cpp:
    309-347): match by vocabulary node (`findORBMatchesByBoW`,
    src/ViewGraph.cpp:125-295), solve the relative pose, reject unless
    the cheirality support reaches ``min_matches``, refine, reject
    unless the final match count still reaches ``min_matches``.  The
    host version of this ran three dispatch+fetch cycles per candidate
    (match_by_bow -> find_relative_pose -> refine_pose).

    Returns (E, R, t, n_che, m12, success) with the pose mapping
    frame-1 -> frame-2 and ``m12`` frame-1 rows -> frame-2 columns.
    """
    from irotavg_tpu.matching.matchers import _match_by_bow_core

    key = jax.random.key(jnp.asarray(seed, jnp.uint32))
    if not has_nodes:
        nodes1 = jnp.zeros(x1.shape, jnp.int32)
        nodes2 = jnp.zeros(x2.shape, jnp.int32)
    m12 = _match_by_bow_core(
        bits1, nodes1, valid1, angle1, bits2t, nodes2, valid2, angle2,
        nnratio, has_nodes=has_nodes,
    ).astype(jnp.int32)
    count0 = jnp.sum(m12 >= 0)
    key, sub = jax.random.split(key)
    E0, R0, t0, n0, pose_mask = _ransac_from_assignment(
        m12, x1, y1, x2, y2, cam, th_norm, sub, n_samples
    )
    # close_loop gates: >4 matches, >6 cheirality inliers, and the
    # pre-refine support floor (src/IRotAvg.cpp:320-326)
    rel_ok = (count0 > 4) & (n0 > 6) & (n0 >= min_matches)
    m12f = jnp.where(pose_mask, m12, -1).astype(jnp.int32)
    cntf = jnp.sum(m12f >= 0)

    key, sub = jax.random.split(key)
    E, R, t, n, m12r, _ = fused_refine(
        bits1, nodes1, valid1, angle1, x1, y1, oct1,
        bits2t, nodes2, valid2, angle2, x2, y2,
        E0, R0, t0, cntf, m12f,
        K_inv, sigma2, cam, th_norm, sub,
        jnp.ceil(0.75 * min_matches).astype(jnp.int32),
        has_nodes=has_nodes, max_iters=max_iters, n_samples=n_samples,
    )
    do_refine = cntf > 10
    f32 = jnp.float32
    E = jnp.where(do_refine, E, E0.astype(f32))
    R = jnp.where(do_refine, R, R0.astype(f32))
    t = jnp.where(do_refine, t, t0.astype(f32))
    n = jnp.where(do_refine, n, n0).astype(jnp.int32)
    m12 = jnp.where(do_refine, m12r, m12f)
    final_cnt = jnp.sum(m12 >= 0)
    success = rel_ok & (final_cnt >= min_matches)
    return E, R, t, n, m12, success


@functools.partial(
    jax.jit,
    static_argnames=("has_nodes", "max_trials", "n_samples", "gate_px"),
)
def fused_process_frame(
    bits_c, nodes_c, valid_c, angle_c, x_c, y_c, oct_c,
    bits_p, nodes_p, valid_p, angle_p, x_p, y_p, oct_p,
    cands, m12_w2p, active_w,
    local_rad0, K_inv, sigma2, cam, th_norm, seed,
    min_matches, min_inliers, nnratio,
    *, has_nodes, max_trials=6, n_samples=512, gate_px=5.0,
):
    """The WHOLE per-frame device pipeline in one program: adaptive
    initial pose, the 5 px keyframe gate, and — under ``lax.cond`` —
    the refine + pivot-chained window walk (src/ViewGraph.cpp:1035-1145).

    The gate decision runs ON DEVICE: rejected frames (~2/3 of real
    sequences) skip the refine/window compute entirely (the cond branch
    is not executed), and every frame costs exactly ONE dispatch + ONE
    bundled fetch.  This supersedes the round-3 two-program split, whose
    rationale was that an unconditionally-fused program wasted the
    refine compute on rejected frames — ``lax.cond`` keeps the no-waste
    property while removing the accepted frames' second dispatch.

    Returns ``(local_rad, rel_valid, refined, window)`` where refined /
    window are as in `fused_refine_window` (zeros when the gate
    rejected — the host discards them, same as not having run phase 2).
    """
    f32 = jnp.float32
    key = jax.random.key(jnp.asarray(seed, jnp.uint32))
    k1, k2 = jax.random.split(key)

    n_feat = x_c.shape[0]
    zeros = jnp.zeros((n_feat,), jnp.int32)
    if not has_nodes:
        nodes_c = nodes_p = zeros
    bits_pt = jnp.swapaxes(bits_p, 0, 1)
    E0, R0, t0, _n0, m12_cp, local_rad, rel_valid, _acc = (
        _initial_pose_core(
            bits_c, valid_c, oct_c, x_c, y_c,
            bits_pt, valid_p, oct_p, x_p, y_p,
            local_rad0, cam, th_norm, k1, min_inliers, nnratio,
            max_trials=max_trials, n_samples=n_samples,
        )
    )
    accept = local_rad >= gate_px

    w_stack = _stack_candidates(cands, n_feat, has_nodes)
    K = len(cands)
    n_prev = x_p.shape[0]

    def do_phase2(_):
        return _refine_window_core(
            bits_c, nodes_c, valid_c, angle_c, x_c, y_c, oct_c,
            bits_p, nodes_p, valid_p, angle_p, x_p, y_p, oct_p,
            w_stack, m12_w2p, active_w, E0, R0, t0, m12_cp,
            K_inv, sigma2, cam, th_norm, k2, min_matches,
            has_nodes=has_nodes, n_samples=n_samples,
        )

    def skip_phase2(_):
        refined = (jnp.zeros((3, 3), f32), jnp.eye(3, dtype=f32),
                   jnp.zeros((3,), f32), jnp.asarray(0, jnp.int32),
                   jnp.full((n_prev,), -1, jnp.int32))
        window = (jnp.zeros((K, 3, 3), f32),
                  jnp.broadcast_to(jnp.eye(3, dtype=f32), (K, 3, 3)),
                  jnp.zeros((K, 3), f32),
                  jnp.zeros((K,), jnp.int32),
                  jnp.full((K, n_feat), -1, jnp.int32),
                  jnp.zeros((K,), bool))
        return refined, window

    refined, window = jax.lax.cond(accept, do_phase2, skip_phase2, None)
    return local_rad, rel_valid, refined, window


@jax.jit
def fused_flow_gather(desc, valid, octave, x, y, ia, ib, radius):
    """`fused_flow` with the per-chunk frame gathers + bit unpacking done
    IN-PROGRAM: callers pass the whole stacked feature arrays (device
    resident) plus index vectors, instead of ~6 host-side dispatches per
    chunk for ``desc[ia]`` / ``unpack_pm1``."""
    from irotavg_tpu.ops.hamming import unpack_pm1

    bitsA = jax.vmap(unpack_pm1)(desc[ia])
    bitsBt = jnp.swapaxes(jax.vmap(unpack_pm1)(desc[ib]), 1, 2)
    return fused_flow(bitsA, valid[ia], octave[ia], x[ia], y[ia],
                      bitsBt, valid[ib], octave[ib], x[ib], y[ib], radius)


@functools.partial(jax.jit, static_argnames=("max_iters", "n_samples"))
def fused_pair_estimate_gather(desc, valid, octave, x, y, angle,
                               ia, ib, radius, K_inv, sigma2, cam,
                               th_norm, seed, min_matches,
                               *, max_iters=10, n_samples=512):
    """`fused_pair_estimate` with in-program gathers + seed scalar (see
    `fused_flow_gather`)."""
    from irotavg_tpu.ops.hamming import unpack_pm1

    key = jax.random.key(jnp.asarray(seed, jnp.uint32))
    bitsA = jax.vmap(unpack_pm1)(desc[ia])
    bitsBt = jnp.swapaxes(jax.vmap(unpack_pm1)(desc[ib]), 1, 2)
    return _pair_estimate_core(
        bitsA, valid[ia], octave[ia], x[ia], y[ia], angle[ia],
        bitsBt, valid[ib], octave[ib], x[ib], y[ib], angle[ib],
        radius, K_inv, sigma2, cam, th_norm, key, min_matches,
        max_iters=max_iters, n_samples=n_samples,
    )


@jax.jit
def fused_flow(bitsA, validA, octA, xA, yA,
               bitsBt, validB, octB, xB, yB, radius):
    """Batched mean feature displacement between frame pairs.

    The offline analogue of `findInitialPose`'s velocity estimate
    (src/ViewGraph.cpp:848-864): per pair, local-window match then the
    mean match displacement in pixels.  Returns (mean_disp (P,),
    n_matches (P,))."""

    def one(bA, vA, oA, xa, ya, bBt, vB, oB, xb, yb):
        m12 = _match_locally_core(
            bA, vA, oA, xa, ya, bBt, vB, oB, xb, yb, radius, 0.9
        )
        matched = m12 >= 0
        count = jnp.sum(matched)
        j = jnp.clip(m12, 0, None)
        disp = jnp.hypot(xa - xb[j], ya - yb[j])
        mean = jnp.sum(jnp.where(matched, disp, 0.0)) / jnp.maximum(count, 1)
        return mean.astype(jnp.float32), count.astype(jnp.int32)

    return jax.vmap(one)(bitsA, validA, octA, xA, yA,
                         bitsBt, validB, octB, xB, yB)
