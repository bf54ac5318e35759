"""Drive the system's main paths once on one GPU and check what comes out.

    python chip_smoke.py [--seed 0]
    python chip_smoke.py --multi          # the edge-sharded solve, 4 GPUs

Phases, each in a child process of its own so that every entry point runs
as a user runs it, and only one process holds the card at a time:

a. incremental SLAM (``python -m irotavg_tpu.app.irotavg``) over a one-way
   two-lap ring sequence rendered at KITTI-00 shape (1241x376 gray,
   fx=718.856, no lens distortion) with the KITTI ORB settings and the
   100k-word vocabulary, without ground truth: poses and ids are written,
   loop closure adds edges, and the gauge-aligned rotation RMSE is within
   a bound measured on the CPU for the same sequence;
b. the offline pipeline (``python -m irotavg_tpu.app.irotavg_batch``) on
   the same frames, with its own RMSE bound;
c. the batch solver (``python -m irotavg_tpu.app.l1_irls``) in f64 on the
   bundled m=3655/n=1832 problem, against the scipy oracle;
d. the matcher (``ops.hamming.best2``) at 2000x2000 keypoints of two
   rendered frames for every gate, against a host XOR+popcount oracle
   with zero tolerance.

``--multi`` runs only the edge-sharded solver over a 4-GPU ``graph`` mesh
on the 50k-view / 250k-edge problem, against the single-device ``irls``
on the same schedule.

The last line of stdout is ``{"ok": true, "device": {...}}``; any failed
phase exits non-zero without it.  Without a GPU, or outside a checkout of
the repository, the script fails before any phase.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(REPO, "tests")
VOCAB_GZ = os.path.join(TESTS, "data", "product_vocab_k10_L5_v1.txt.gz")
PROBLEM_GZ = os.path.join(TESTS, "data", "ravg_input.txt.gz")

# KITTI odometry sequence 00: image size and focal length (ORB-SLAM2's
# KITTI00-02.yaml); the ORB settings are that file's.
KITTI00_SIZE = (1241, 376)
KITTI00_FX = 718.856
KITTI_ORB = ("ORBextractor.nFeatures: 2000\nORBextractor.scaleFactor: 1.2\n"
             "ORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\n"
             "ORBextractor.minThFAST: 7\n")

FRAMES = 200           # two laps, 3.6 deg of yaw per frame

# Rotation RMSE bounds (deg) for --seed 0: twice what the
# CPU backend gave for the same sequence (RMSE_CPU_*), which leaves room
# for the GPU's other summation order sending RANSAC down other branches.
RMSE_CPU_INCREMENTAL = 2.2929
RMSE_CPU_OFFLINE = 2.0316
RMSE_BOUND_INCREMENTAL = 2 * RMSE_CPU_INCREMENTAL
RMSE_BOUND_OFFLINE = 2 * RMSE_CPU_OFFLINE
# phase c: headline.quality_ok's criterion against the scipy oracle
L1_IRLS_MAX_DEG = 0.06
# --multi: sharded vs single-device geodesic difference, f32 CG on both
MULTI_MEAN_DEG = 0.01
MULTI_P99_DEG = 0.1

_TIMING = "chip_smoke timing:"


def _run(cmd, *, env=None, timeout):
    """Run a child to completion; failure (or the timeout, which kills
    the child) raises, echoing the end of its output."""
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                       env=env, timeout=timeout)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        sys.stdout.write(r.stdout[-4000:])
        sys.stderr.write(r.stderr[-8000:])
        raise RuntimeError(f"{' '.join(cmd[:4])} ... exited {r.returncode}")
    return r.stdout, wall


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _cli(module, *args, timeout):
    """Run ``python -m module args`` through a wrapper that adds up the
    XLA compile (or compile-cache load) time of every program; returns
    (stdout, wall, compile)."""
    out, wall = _run([sys.executable, __file__, "--child-cli", module,
                      *map(str, args)], timeout=timeout)
    m = re.search(_TIMING + r" compile_s=([0-9.]+)", out)
    return out, wall, float(m.group(1))


def _rmse_deg(poses_path, ids_path, R_gt):
    """Gauge-aligned rotation RMSE of a poses file against R_gt."""
    import numpy as np
    from scipy.spatial.transform import Rotation as Rsc

    poses = np.loadtxt(poses_path, ndmin=2)
    ids = np.loadtxt(ids_path, dtype=int, ndmin=1)
    if len(poses) != len(ids) or len(poses) < 2:
        raise RuntimeError(f"{len(poses)} poses for {len(ids)} ids")
    q = poses[:, 1:5]
    est = Rsc.from_quat(np.concatenate([q[:, 1:], q[:, :1]], axis=1))
    gt = Rsc.from_matrix(R_gt[ids - 1])
    rel = (est * est[0].inv()) * (gt * gt[0].inv()).inv()
    err = np.degrees(rel.magnitude())
    return float(np.sqrt(np.mean(err ** 2))), len(poses)


def _check(cond, msg):
    print(("  ok    " if cond else "  FAIL  ") + msg, flush=True)
    if not cond:
        raise RuntimeError(msg)


def _probe_devices():
    out, _ = _run([sys.executable, __file__, "--child-devices"], timeout=300)
    dev = json.loads(out.strip().splitlines()[-1])
    print(f"jax.devices(): {dev['repr']}", flush=True)
    return dev


def _nvidia_smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    for line in r.stdout.strip().splitlines():
        print(f"card: {line.strip()}", flush=True)


def phase_slam(work, R_gt):
    print("phase a: incremental SLAM (irotavg_tpu.app.irotavg)", flush=True)
    out_dir = os.path.join(work, "out_incremental")
    out, wall, comp = _cli("irotavg_tpu.app.irotavg", work + "/vocab.txt",
                           work + "/kitti00.yaml", work + "/seq",
                           "--out_dir", out_dir, timeout=500)
    print(f"  wall {wall:.1f} s (XLA compile {comp:.1f} s, rest "
          f"{wall - comp:.1f} s)", flush=True)
    loops = len(re.findall(r"new connection:", out))
    rmse, n_views = _rmse_deg(os.path.join(out_dir, "rotavg_poses.txt"),
                              os.path.join(out_dir, "rotavg_poses_ids.txt"),
                              R_gt)
    _check(n_views > FRAMES // 4,
           f"poses and ids written: {n_views} keyframes of {FRAMES}")
    _check(loops > 0, f"loop edges: {loops}")
    _check(rmse <= RMSE_BOUND_INCREMENTAL,
           f"rotation RMSE {rmse:.4f} deg <= {RMSE_BOUND_INCREMENTAL:.4f} "
           f"(CPU: {RMSE_CPU_INCREMENTAL})")


def phase_offline(work, R_gt):
    print("phase b: offline pipeline (irotavg_tpu.app.irotavg_batch)",
          flush=True)
    out_dir = os.path.join(work, "out_offline")
    out, wall, comp = _cli("irotavg_tpu.app.irotavg_batch",
                           work + "/vocab.txt", work + "/kitti00.yaml",
                           work + "/seq", "--out_dir", out_dir, timeout=350)
    print(f"  wall {wall:.1f} s (XLA compile {comp:.1f} s, rest "
          f"{wall - comp:.1f} s)", flush=True)
    for line in out.splitlines():
        if re.match(r"(keyframes|extract|flow|pairs|loop|solve|total):",
                    line.strip()):
            print("  " + line.strip(), flush=True)
    m = re.search(r"\((\d+) loop\)", out)
    rmse, n_views = _rmse_deg(os.path.join(out_dir, "rotavg_poses.txt"),
                              os.path.join(out_dir, "rotavg_poses_ids.txt"),
                              R_gt)
    _check(n_views > FRAMES // 4,
           f"poses and ids written: {n_views} keyframes of {FRAMES}")
    _check(m is not None and int(m.group(1)) > 0,
           f"loop edges: {m.group(1) if m else 'none reported'}")
    _check(rmse <= RMSE_BOUND_OFFLINE,
           f"rotation RMSE {rmse:.4f} deg <= {RMSE_BOUND_OFFLINE:.4f} "
           f"(CPU: {RMSE_CPU_OFFLINE})")


def phase_l1_irls(work):
    print("phase c: batch solver (irotavg_tpu.app.l1_irls, f64)", flush=True)
    sol = os.path.join(work, "l1_irls_out.txt")
    out, wall, comp = _cli("irotavg_tpu.app.l1_irls", PROBLEM_GZ, sol,
                           timeout=150)
    print(f"  wall {wall:.1f} s (XLA compile {comp:.1f} s, rest "
          f"{wall - comp:.1f} s)", flush=True)
    for line in out.splitlines():
        if "iterations" in line or "runtime" in line:
            print("  " + line.strip(), flush=True)
    # the oracle runs on the host CPU, in a child that never opens the card
    res, _ = _run([sys.executable, __file__, "--child-l1-oracle", sol],
                  env=_cpu_env(), timeout=150)
    err = json.loads(res.strip().splitlines()[-1])
    _check(err["n"] == 1832, f"{err['n']} rotations written")
    _check(err["max_deg"] < L1_IRLS_MAX_DEG,
           f"vs scipy oracle: max {err['max_deg']:.5f} deg, mean "
           f"{err['mean_deg']:.6f} deg (< {L1_IRLS_MAX_DEG})")


def phase_matcher(work):
    print("phase d: matcher best2 at 2000x2000 (ops.hamming)", flush=True)
    out, wall = _run([sys.executable, __file__, "--child-matcher", work],
                     timeout=200)
    print(f"  wall {wall:.1f} s", flush=True)
    res = json.loads(out.strip().splitlines()[-1])
    for gate, r in res.items():
        _check(r["d1"] and r["d2"] and r["idx"],
               f"gate {gate}: {r['n1']}x{r['n2']}, {r['matched']} rows "
               f"matched; d1, d2, idx equal to the oracle "
               f"({r['ms']:.3f} ms per call)")


def phase_multi():
    print("phase multi: edge-sharded solve over a 4-GPU mesh", flush=True)
    out, wall = _run([sys.executable, __file__, "--child-multi"],
                     timeout=600)
    print(f"  wall {wall:.1f} s", flush=True)
    res = json.loads(out.strip().splitlines()[-1])
    print(f"  {res['n_views']} views, {res['n_edges']} edges; sharded "
          f"{res['sharded_s']:.3f} s ({res['sharded_iters']} iters), "
          f"single device {res['single_s']:.3f} s "
          f"({res['single_iters']} iters)", flush=True)
    _check(res["mean_deg"] < MULTI_MEAN_DEG and res["p99_deg"] < MULTI_P99_DEG,
           f"sharded vs single device: mean {res['mean_deg']:.6f} deg "
           f"(< {MULTI_MEAN_DEG}), p99 {res['p99_deg']:.6f} deg "
           f"(< {MULTI_P99_DEG}), max {res['max_deg']:.4f} deg (reported)")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU edge-sharded solve")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "irotavg_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2

    dev = _probe_devices()
    if dev["platform"] != "gpu":
        print(f"no GPU: JAX found {dev['platform']}", file=sys.stderr)
        return 1
    _nvidia_smi()
    want = 4 if args.multi else 1
    if dev["count"] < want:
        print(f"need {want} GPUs, JAX found {dev['count']}", file=sys.stderr)
        return 1

    if args.multi:
        phase_multi()
        count = 4
    else:
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            t0 = time.perf_counter()
            _run([sys.executable, __file__, "--child-render", work,
                  str(args.seed), str(FRAMES)], env=_cpu_env(),
                 timeout=200)
            with gzip.open(VOCAB_GZ, "rb") as src, \
                    open(os.path.join(work, "vocab.txt"), "wb") as dst:
                shutil.copyfileobj(src, dst)
            print(f"data: {FRAMES} frames rendered, vocabulary "
                  f"unpacked in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            import numpy as np

            R_gt = np.load(os.path.join(work, "R_gt.npy"))
            phase_slam(work, R_gt)
            phase_offline(work, R_gt)
            phase_l1_irls(work)
            phase_matcher(work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": count}}))
    return 0


# ---------------------------------------------------------------------------
# children
# ---------------------------------------------------------------------------

def child_devices():
    import jax

    devs = jax.devices()
    print(json.dumps({"platform": devs[0].platform,
                      "kind": devs[0].device_kind, "count": len(devs),
                      "repr": repr(devs)}))


def child_cli(module, argv):
    import runpy

    import jax.monitoring

    compile_s = [0.0]

    def on_event(event, duration, **_):
        # not the trace and lowering events: nested jits record those
        # inside their caller's, so they would count twice
        if event == "/jax/core/compile/backend_compile_duration":
            compile_s[0] += duration

    jax.monitoring.register_event_duration_secs_listener(on_event)
    sys.argv = [module, *argv]
    code = 0
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        code = e.code
    print(f"{_TIMING} compile_s={compile_s[0]:.3f}", flush=True)
    sys.exit(code)


def child_render(work, seed, n_frames):
    sys.path.insert(0, TESTS)
    import numpy as np
    from seqgen import make_ring_sequence

    from irotavg_tpu.utils.png import write_png

    frames, K, R_gt = make_ring_sequence(
        n_frames=n_frames, size=KITTI00_SIZE, fx=KITTI00_FX, seed=seed,
        laps=2.0)
    seq = os.path.join(work, "seq")
    os.makedirs(seq)
    for i, im in enumerate(frames):
        write_png(os.path.join(seq, f"{i:06d}.png"), im)
    np.save(os.path.join(work, "R_gt.npy"), R_gt)
    with open(os.path.join(work, "kitti00.yaml"), "w") as fh:
        fh.write("%YAML:1.0\n"
                 f"Camera.fx: {K[0, 0]}\nCamera.fy: {K[1, 1]}\n"
                 f"Camera.cx: {K[0, 2]}\nCamera.cy: {K[1, 2]}\n"
                 "Camera.k1: 0.0\nCamera.k2: 0.0\n"
                 "Camera.p1: 0.0\nCamera.p2: 0.0\n" + KITTI_ORB)


def child_l1_oracle(sol_path):
    """Solve the bundled problem with the scipy oracle (the l1_irls CLI's
    defaults) and compare with the CLI's output rotations."""
    sys.path.insert(0, TESTS)
    import numpy as np
    import ref_impl as oracle

    from irotavg_tpu.solver.init import init_mst
    from irotavg_tpu.solver.io import read_problem

    p = read_problem(PROBLEM_GZ)
    Q, f = p["Q"], p["f"]
    if f == 0:
        Q[0] = (0.0, 0.0, 0.0, 1.0)
        f = 1
    Q0 = init_mst(Q, p["QQ"], p["edges"], max(p["n_abs_given"], f))
    A = oracle.make_A(len(Q0), f, p["edges"])
    Qb, _, _ = oracle.l1ra(p["QQ"], p["edges"], A, Q0.copy(), f,
                           max_iters=5, change_th=1e-3)
    Qb, _, _, _ = oracle.irls(p["QQ"], p["edges"], A, "Geman-McClure",
                              np.deg2rad(5.0), Qb, f, max_iters=50,
                              change_th=1e-3)
    Qb = Qb / np.linalg.norm(Qb, axis=1, keepdims=True)
    wxyz = np.loadtxt(sol_path, max_rows=len(Qb), ndmin=2)
    Qs = np.concatenate([wxyz[:, 1:], wxyz[:, :1]], axis=1)   # x y z w
    d = np.clip(np.abs(np.sum(Qs * Qb, axis=1)), 0.0, 1.0)
    err = np.degrees(2.0 * np.arccos(d))
    print(json.dumps({"n": len(Qs), "max_deg": float(err.max()),
                      "mean_deg": float(err.mean())}))


def child_matcher(work):
    """best2 on the card for every gate at 2000x2000 keypoints of two
    rendered frames, against a host XOR+popcount oracle."""
    sys.path.insert(0, TESTS)
    import jax
    import numpy as np
    import ref_impl as oracle

    from irotavg_tpu.frontend import ORBExtractor
    from irotavg_tpu.ops.hamming import (
        BIG, GATES, best2, make_colft, make_rowf, unpack_pm1,
    )
    from irotavg_tpu.utils.png import read_gray

    ext = ORBExtractor(n_features=2000, scale_factor=1.2, n_levels=8,
                       ini_th_fast=20, min_th_fast=7)
    a, b = ({k: np.asarray(v) for k, v in ext(read_gray(
        os.path.join(work, "seq", f"{i:06d}.png"))).items()} for i in (0, 3))
    n1, n2 = len(a["desc"]), len(b["desc"])
    rng = np.random.default_rng(0)
    # vocabulary-node stand-in: 12 partitions by descriptor bits
    node1 = (a["desc"][:, 0] % 12).astype(np.float32)
    node2 = (b["desc"][:, 0] % 12).astype(np.float32)
    # epipolar lines with small integer coefficients through integer
    # points: every product and sum of the gate is exact in f32
    xi, yi = np.round(a["x0"]), np.round(a["y0"])
    la = rng.integers(-1, 2, n2).astype(np.float32)
    lb = rng.integers(-1, 2, n2).astype(np.float32)
    lc = rng.integers(-900, 900, n2).astype(np.float32)

    def feats(gate):
        if gate in ("none", "node"):
            return (make_rowf(a["valid"], node=node1),
                    make_colft(b["valid"], node=node2))
        if gate == "local":
            return (make_rowf(a["valid"], x=a["x0"], y=a["y0"],
                              octave=a["octave"],
                              th=np.full(n1, 100.0, np.float32)),
                    make_colft(b["valid"], x=b["x0"], y=b["y0"],
                               octave=b["octave"]))
        return (make_rowf(a["valid"], node=node1, x=xi, y=yi,
                          th=np.full(n1, 400.0, np.float32)),
                make_colft(b["valid"], node=node2, a=la, b=lb, c=lc))

    bits1 = unpack_pm1(a["desc"])
    bits2t = unpack_pm1(b["desc"]).T
    fn = jax.jit(best2, static_argnames="gate")
    res = {}
    for gate in GATES:
        rowf, colft = feats(gate)
        got = [np.asarray(v) for v in fn(bits1, bits2t, rowf, colft,
                                         gate=gate)]
        t0 = time.perf_counter()
        for _ in range(20):
            out = fn(bits1, bits2t, rowf, colft, gate=gate)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / 20 * 1e3
        d1, d2, idx = oracle.best2(gate, a["desc"], b["desc"], rowf, colft)
        has = d1 < BIG
        res[gate] = {
            "n1": n1, "n2": n2, "matched": int(has.sum()), "ms": ms,
            "d1": bool(np.array_equal(got[0], d1)),
            "d2": bool(np.array_equal(got[1], d2)),
            "idx": bool(np.array_equal(got[2], idx)),
        }
    print(json.dumps(res))


def child_multi(n=50_000, m_extra=200_000):
    """sharded_ravg_pipeline over a 4-device mesh vs single-device irls on
    the 50k-view / 250k-edge problem of bench.py's large section."""
    sys.path.insert(0, TESTS)
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy.spatial.transform import Rotation as Rsc
    from synth import make_problem

    from irotavg_tpu import so3
    from irotavg_tpu.parallel import (
        make_graph_mesh, shard_graph, sharded_ravg_pipeline,
    )
    from irotavg_tpu.solver import RotationGraph
    from irotavg_tpu.solver.irls import Cost, IRLSConfig, irls

    l1_iters = 5
    p = make_problem(n=n, extra_edges=m_extra, noise_deg=3.0,
                     outlier_frac=0.1, seed=11)
    rng = np.random.default_rng(12)
    pert = Rsc.from_rotvec(rng.normal(scale=np.radians(3.0), size=(n, 3)))
    Q0 = (pert * Rsc.from_quat(p["Q_gt"])).as_quat()
    Q0[0] = p["Q_gt"][0]
    m = len(p["edges"])
    g = RotationGraph.create(p["edges"], p["QQ"], Q0, f=1,
                             dtype=jnp.float32).pad_to(-(-m // 4) * 4, n)
    cfg = IRLSConfig(max_iters=100, change_th=1e-4, backend="cg",
                     cg_tol=1e-6, cg_maxiter=200)

    mesh = make_graph_mesh(4)
    solve = sharded_ravg_pipeline(mesh, l1_iters=l1_iters, cfg=cfg)
    gs = shard_graph(g, mesh)
    Qm, _, it_m, _ = solve(gs)
    Qm.block_until_ready()
    t0 = time.perf_counter()
    Qm, _, it_m, _ = solve(gs)
    Qm.block_until_ready()
    sharded_s = time.perf_counter() - t0

    @jax.jit
    def single(g):
        Q1, _, it1, _ = irls(g, dataclasses.replace(cfg, cost=Cost.L1,
                                                    max_iters=l1_iters))
        Q2, _, it2, _ = irls(dataclasses.replace(g, Q=Q1), cfg)
        return so3.qnormalize(Q2), it1 + it2

    g1 = jax.device_put(g, jax.devices()[0])
    Qs, it_s = single(g1)
    Qs.block_until_ready()
    t0 = time.perf_counter()
    Qs, it_s = single(g1)
    Qs.block_until_ready()
    single_s = time.perf_counter() - t0

    d = np.abs(np.sum(np.asarray(Qm) * np.asarray(Qs), axis=-1))
    err = np.degrees(2.0 * np.arccos(np.clip(d, 0.0, 1.0)))
    print(json.dumps({
        "n_views": n, "n_edges": m, "sharded_s": sharded_s,
        "single_s": single_s, "sharded_iters": int(it_m),
        "single_iters": int(it_s), "mean_deg": float(err.mean()),
        "p99_deg": float(np.percentile(err, 99)),
        "max_deg": float(err.max()),
    }))


_CHILDREN = {
    "--child-devices": lambda a: child_devices(),
    "--child-cli": lambda a: child_cli(a[0], a[1:]),
    "--child-render": lambda a: child_render(a[0], int(a[1]), int(a[2])),
    "--child-l1-oracle": lambda a: child_l1_oracle(a[0]),
    "--child-matcher": lambda a: child_matcher(a[0]),
    "--child-multi": lambda a: child_multi(*map(int, a)),
}

if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] in _CHILDREN:
        sys.path.insert(0, REPO)
        _CHILDREN[sys.argv[1]](sys.argv[2:])
    else:
        sys.exit(main())
