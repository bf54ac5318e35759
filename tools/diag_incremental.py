"""Incremental-vs-offline accuracy diagnosis on CPU.

Runs the incremental engine over the bench sequence, then breaks the
error down three ways to locate where accuracy is lost relative to the
offline pipeline on the same generator:

1. per-edge relative-rotation error vs GT, split by edge provenance
   (prev-frame edge, pivot-chained window edge, loop edge);
2. final incremental state RMSE (what the bench reports);
3. RMSE after ONE global batch re-solve of the exact same collected
   graph — if (3) is much better than (2), the solve *schedule* (windowed
   warm starts) is the gap; if the window edges in (1) are much noisier
   than prev edges, the pivot chain is the gap.

Usage: python tools/diag_incremental.py [n_frames] [seed]
"""

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from irotavg_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()


def main():
    from scipy.spatial.transform import Rotation as Rsc
    from seqgen import make_sequence
    from irotavg_tpu import so3
    from irotavg_tpu.engine.viewgraph import FrameConnectionError, ViewGraph
    from irotavg_tpu.frontend import Camera, FramePrefetcher, ORBExtractor

    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 80
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    noise = dict(noise_sigma=5.0, blur_sigma=0.6, k1=-0.28, k2=0.07)
    if os.environ.get("DIAG_CLEAN"):
        noise = {}
    noise["noise_sigma"] = float(os.environ.get("DIAG_NOISE", "5.0"))
    frames, K, R_gt = make_sequence(
        n_frames=n_frames, seed=seed, loop=True,
        passes=int(os.environ.get("DIAG_PASSES", "1")), **noise)
    cam = Camera(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                 width=640, height=480,
                 k1=noise.get("k1", 0.0), k2=noise.get("k2", 0.0))
    ext = ORBExtractor(n_features=1000, n_levels=8)
    vg = ViewGraph(cam, min_matches=50)

    vocab = None
    cache = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), ".bench_cache", "product_vocab_k10_L5_v1.txt")
    if os.path.exists(cache) and not os.environ.get("DIAG_NOLOOP"):
        from irotavg_tpu.placerec.vocabulary import Vocabulary

        vocab = Vocabulary.load_text(cache)
    pf = FramePrefetcher(frames, ext, cam, batch=8, vocab=vocab)

    kept, view_ids, dropped, loop_keys = [], [], 0, set()
    gt_every = 20
    t0 = time.perf_counter()
    for i in range(n_frames):
        f = pf.frame(i)
        try:
            ok = vg.process_frame(f, win_size=4)
        except FrameConnectionError:
            dropped += 1
            ok = False
        if not ok:
            continue
        kept.append(i)
        view_ids.append(vg.num_views - 1)
        view_id = vg.num_views - 1
        loop_new = False
        if vocab is not None:
            cands = vg.detect_loop_candidates(view_id)
            consistent = vg.check_loop_consistency(cands) if cands else []
            for cand in consistent:
                if vg.close_loop(view_id, cand, min_matches=150):
                    loop_keys.add((cand, view_id))
                    loop_new = True
            vg.add_to_database(view_id)
        fixed = False
        if i % gt_every == 0:
            vg.fix_pose(view_id, np.asarray(so3.rotmat_to_quat(R_gt[i])))
            fixed = True
        vg.rot_avg(5_000_000 if (fixed or loop_new) else 10)
    run_s = time.perf_counter() - t0

    # ---- (1) per-edge error by provenance --------------------------------
    v2f = {}
    for kf_i, vid in zip(kept, view_ids):
        v2f[vid] = kf_i
    # dropped frames still created views; map every view to a frame
    all_pairs = sorted(vg.connections.keys())
    Rg = R_gt

    def frame_of(v):
        return v2f.get(v)

    rows = {"prev": [], "window": [], "loop": []}
    for (i, j) in all_pairs:
        fi, fj = frame_of(i), frame_of(j)
        if fi is None or fj is None:
            continue
        q = vg.connections[(i, j)].pose.q
        R_rel_gt = Rg[fj] @ Rg[fi].T
        q_gt = Rsc.from_matrix(R_rel_gt).as_quat()
        d = abs(float(np.dot(np.asarray(q), q_gt)))
        e = np.degrees(2 * np.arccos(min(d, 1.0)))
        if (i, j) in loop_keys:
            rows["loop"].append(e)
        elif j - i == 1:
            rows["prev"].append(e)
        else:
            rows["window"].append(e)
    edge_report = {
        k: {"n": len(v),
            "mean": round(float(np.mean(v)), 3) if v else None,
            "p90": round(float(np.percentile(v, 90)), 3) if v else None}
        for k, v in rows.items()
    }

    # ---- (2) final incremental RMSE --------------------------------------
    q_est = vg.ra.Q[view_ids]
    q_gt = np.stack([np.asarray(so3.rotmat_to_quat(Rg[i])) for i in kept])
    qa = so3.qmul(q_est, np.tile(so3.qinv_flipw(q_est[0]), (len(q_est), 1)))
    qb = so3.qmul(q_gt, np.tile(so3.qinv_flipw(q_gt[0]), (len(q_gt), 1)))
    err = np.degrees(np.asarray(so3.qgeodesic(so3.qnormalize(qa), qb)))
    rmse_inc = float(np.sqrt((err ** 2).mean()))

    # ---- (3) one global batch re-solve of the same graph -----------------
    import dataclasses

    from irotavg_tpu.solver import RotationGraph, init_mst, irls, l1ra
    from irotavg_tpu.solver.irls import Cost, IRLSConfig
    from irotavg_tpu.solver.l1ra import L1RAConfig

    ra = vg.ra
    Q0 = np.zeros_like(ra.Q)
    Q0[0] = [0, 0, 0, 1]
    Q0 = init_mst(Q0, ra.QQ, ra.edges, 1)
    g = RotationGraph.create(ra.edges, ra.QQ, Q0, f=1)
    g = dataclasses.replace(
        g, Q=l1ra(g, L1RAConfig(max_iters=5, change_th=1e-3))[0])
    Qf, _, _, _ = irls(g, IRLSConfig(
        cost=Cost.parse("Geman-McClure"), sigma=float(np.radians(5.0)),
        max_iters=50, change_th=1e-3, backend="dense"))
    Qf = np.asarray(so3.qnormalize(Qf))
    q_est2 = Qf[view_ids]
    qa2 = so3.qmul(q_est2,
                   np.tile(so3.qinv_flipw(q_est2[0]), (len(q_est2), 1)))
    err2 = np.degrees(np.asarray(so3.qgeodesic(so3.qnormalize(qa2), qb)))
    rmse_global = float(np.sqrt((err2 ** 2).mean()))

    print(json.dumps({
        "frames": n_frames, "kept": len(kept), "dropped": dropped,
        "run_s": round(run_s, 1),
        "loop_edges": len(loop_keys),
        "edges": edge_report,
        "rmse_incremental": round(rmse_inc, 3),
        "rmse_global_resolve": round(rmse_global, 3),
        "max_err_incremental": round(float(err.max()), 3),
    }))


if __name__ == "__main__":
    main()
