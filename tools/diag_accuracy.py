"""Accuracy diagnostics on CPU: offline pipeline RMSE with/without loop
closure on the (noisy, distorted) bench workload, plus per-edge error
breakdown.  Development tool for tuning the bench sequences — run as
``python tools/diag_accuracy.py [n_frames] [seed]``.
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
    from irotavg_tpu.frontend.camera import Camera
    from irotavg_tpu.frontend.orb import ORBExtractor
    from irotavg_tpu.pipeline.offline import run_offline

    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 80
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    noise = dict(noise_sigma=float(os.environ.get("DIAG_NOISE", "5.0")),
                 blur_sigma=0.6, k1=-0.28, k2=0.07)
    if os.environ.get("DIAG_CLEAN"):
        noise = {}

    t0 = time.perf_counter()
    if os.environ.get("DIAG_RING"):
        from seqgen import make_ring_sequence

        frames, K, R_gt = make_ring_sequence(
            n_frames=n_frames, seed=seed,
            laps=float(os.environ.get("DIAG_LAPS", "2")), **noise)
    else:
        frames, K, R_gt = make_sequence(
            n_frames=n_frames, seed=seed, loop=True,
            passes=int(os.environ.get("DIAG_PASSES", "1")), **noise)
    print(f"seqgen {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    cam = Camera(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                 width=640, height=480,
                 k1=noise.get("k1", 0.0), k2=noise.get("k2", 0.0))
    ext = ORBExtractor(n_features=1000, n_levels=8)

    def rmse(r):
        Rs = Rsc.from_quat(np.array(r.Q))
        gt = Rsc.from_matrix(np.array(R_gt[r.keyframes]))
        rel = (Rs[0].inv() * Rs).inv() * (gt[0].inv() * gt)
        err = rel.magnitude() * 180.0 / np.pi
        return float(np.sqrt((err ** 2).mean())), float(err.max())

    def edge_stats(r):
        kfs = np.asarray(r.keyframes)
        Rg = np.array(R_gt)
        R_rel_gt = Rg[kfs[r.edges[:, 1]]] @ np.swapaxes(
            Rg[kfs[r.edges[:, 0]]], 1, 2)
        q_rel_gt = Rsc.from_matrix(R_rel_gt).as_quat()
        d = np.abs(np.sum(np.array(r.QQ) * q_rel_gt, axis=-1))
        e = np.degrees(2 * np.arccos(np.clip(d, -1, 1)))
        span = kfs[r.edges[:, 1]] - kfs[r.edges[:, 0]]
        return e, span

    t0 = time.perf_counter()
    res_nl = run_offline(frames, cam, ext, vocab=None, batch=8, chunk=8,
                         min_matches=40)
    t_nl = time.perf_counter() - t0
    r_nl, m_nl = rmse(res_nl)
    e, span = edge_stats(res_nl)
    print(json.dumps({
        "noloop": {
            "s": round(t_nl, 1), "kf": len(res_nl.keyframes),
            "edges": int(len(res_nl.edges)),
            "rmse": round(r_nl, 3), "max": round(m_nl, 3),
            "edge_err_mean": round(float(e.mean()), 3),
            "edge_err_p90": round(float(np.percentile(e, 90)), 3),
            "edge_err_by_span": {
                str(s): round(float(e[span == s].mean()), 3)
                for s in np.unique(span)
            },
        }
    }))

    # loop closure with a quick vocab (or the cached product vocab)
    vocab = None
    cache = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), ".bench_cache", "product_vocab_k10_L5_v1.txt")
    if os.path.exists(cache):
        from irotavg_tpu.placerec.vocabulary import Vocabulary

        vocab = Vocabulary.load_text(cache)
    else:
        from irotavg_tpu.frontend.prefetch import sample_descriptors
        from irotavg_tpu.placerec import train_vocabulary_flat

        t0 = time.perf_counter()
        sample = sample_descriptors(frames, ext, stride=2, cap=800)
        vocab = train_vocabulary_flat(sample, k=10, L=4, seed=0, iters=4)
        print(f"vocab k10L4 {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)
    t0 = time.perf_counter()
    res = run_offline(frames, cam, ext, vocab=vocab, batch=8, chunk=8,
                      min_matches=40)
    t_l = time.perf_counter() - t0
    r_l, m_l = rmse(res)
    e_l, _ = edge_stats(res)
    lm = res.loop_mask
    print(json.dumps({
        "loop": {
            "loop_edge_err_mean": (round(float(e_l[lm].mean()), 3)
                                   if lm.any() else None),
            "seq_edge_err_mean": round(float(e_l[~lm].mean()), 3),
            "s": round(t_l, 1), "kf": len(res.keyframes),
            "edges": int(len(res.edges)),
            "loop_edges": int(res.loop_edges),
            "cand_pairs": int(res.stats.get("loop_candidate_pairs", 0)),
            "vocab_words": int(vocab.n_words),
            "rmse": round(r_l, 3), "max": round(m_l, 3),
            "gain": round(r_nl / max(r_l, 1e-9), 2),
        }
    }))


if __name__ == "__main__":
    main()
