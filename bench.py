"""Benchmark: rotation-averaging framework on the reference workloads.

Timeout-proof harness (round-5 contract):

* The driver records only the LAST ~2000 characters of stdout and parses
  a JSON line out of them.  Round 3 lost its record to a >2000-char line
  and round 4 to a timeout with the single print at the very end.  So
  this harness (a) prints a COMPACT merged JSON line (<1.5 KB) after
  EVERY completed section — a kill at any point leaves the latest full
  line in the tail — and (b) writes complete per-section detail to
  ``BENCH_FULL.json`` next to this file as sections finish.
* A wall-clock budget (``BENCH_BUDGET_S``, default 900 s) gates every
  section: when the remaining time is below a section's floor the
  section is skipped and recorded as such — the reference's observables
  always emit (per-frame printf, src/IRotAvg.cpp:382-383; solver runtime
  prints, ral/test.cpp:307-309), and so does this.
* A watchdog THREAD (not a signal — a stalled remote device call holds
  the GIL-released C call and Python signal handlers wait) force-emits
  the current record and exits 0 at budget + grace.  SIGTERM (what
  ``timeout`` sends) also emits before exiting.

Sections (all on the session accelerator unless noted):

* headline — batch robust solve (init_mst -> L1-RA -> IRLS, reference
  defaults) on the bundled real problem (m=3655, n=1832,
  ral/data/ravg_input.txt) vs the in-repo scipy oracle.
* scaling — 1/2/4/8-device virtual-mesh probe (CPU subprocess), run
  EARLY so host contention from later sections cannot skew it.
* incremental — the reference's actual product: per-frame SLAM with
  loop closure + windowed rotavg (src/IRotAvg.cpp:251-392), driven with
  the >=100k-word product vocabulary.
* e2e — offline batched pipeline on a drift-accumulating sequence with
  photometric noise and lens distortion (k1 != 0 exercises the
  undistortKeypoints path, src/Frame.cpp:102-139); with/without loop
  closure to measure the loop-closure accuracy payoff.
* windows — batched independent window solves + a saturation sweep of
  the batched Cholesky kernel (solves/s knee + TFLOP/s).
* vocab — production-scale k=10/L=6 (~1M node, ~145 MB) text round trip
  through the native parser + descent/cascade timings at 100k words.
* large — cold 50k-view / 250k-edge CG solve with f64 cross-check.
"""

import dataclasses
import json
import os
import signal
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

PROBLEM = os.path.join(REPO, "tests", "data", "ravg_input.txt.gz")
FULL_PATH = os.path.join(REPO, "BENCH_FULL.json")
REPS = 5

# ---------------------------------------------------------------------------
# harness state
# ---------------------------------------------------------------------------

_T0 = time.monotonic()
_BUDGET = float(os.environ.get("BENCH_BUDGET_S", "900"))
_GRACE = 90.0
_LOCK = threading.Lock()
_COMPACT: dict = {}
_FULL: dict = {}


def _remaining() -> float:
    return _BUDGET - (time.monotonic() - _T0)


def _emit(final: bool = False) -> None:
    """Write BENCH_FULL.json and print the compact merged line."""
    with _LOCK:
        _COMPACT["elapsed_s"] = round(time.monotonic() - _T0, 1)
        _FULL["elapsed_s"] = _COMPACT["elapsed_s"]
        try:
            tmp = FULL_PATH + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(_FULL, fh, indent=1)
            os.replace(tmp, FULL_PATH)
        except OSError:
            pass
        line = json.dumps(_COMPACT, separators=(",", ":"))
        if len(line) > 1800:  # never exceed the driver's 2000-char tail
            slim = {k: _COMPACT[k] for k in
                    ("metric", "value", "unit", "vs_baseline", "platform",
                     "quality_ok", "elapsed_s", "detail") if k in _COMPACT}
            line = json.dumps(slim, separators=(",", ":"))
        print(line, flush=True)


def _die(origin: str) -> None:
    _COMPACT["aborted"] = origin
    _FULL["aborted"] = origin
    _emit(final=True)
    os._exit(0)


def _install_watchdog() -> None:
    def watch():
        stop = _T0 + _BUDGET + _GRACE
        while time.monotonic() < stop:
            time.sleep(min(5.0, stop - time.monotonic()))
        _die("watchdog")

    t = threading.Thread(target=watch, daemon=True, name="bench-watchdog")
    t.start()
    try:
        signal.signal(signal.SIGTERM, lambda *_: _die("sigterm"))
    except ValueError:
        pass  # non-main thread


# ---------------------------------------------------------------------------
# shared fixtures
# ---------------------------------------------------------------------------

def _cache_dir() -> str:
    d = os.path.join(REPO, ".bench_cache")
    os.makedirs(d, exist_ok=True)
    return d


_PRODUCT_VOCAB = None


def product_vocab(allow_build: bool = True):
    """The >=100k-word product vocabulary (k=10/L=5, trained
    level-synchronously on synthetic-world ORB descriptors) shared by the
    incremental and e2e sections — the stand-in for shipping ORBvoc.txt
    at its real word count (TemplatedVocabulary.h:1337-1424).

    Resolution order: in-process memo -> cache-dir text (native parse,
    <0.5 s) -> repo fixture gz -> train from scratch (budget permitting).
    Returns None only when absent everywhere and the budget is gone.
    """
    global _PRODUCT_VOCAB
    if _PRODUCT_VOCAB is not None:
        return _PRODUCT_VOCAB
    from irotavg_tpu.placerec.vocabulary import Vocabulary

    path = os.path.join(_cache_dir(), "product_vocab_k10_L5_v1.txt")
    fixture = os.path.join(REPO, "tests", "data",
                           "product_vocab_k10_L5_v1.txt.gz")
    if not os.path.exists(path) and os.path.exists(fixture):
        import gzip
        import shutil

        with gzip.open(fixture, "rb") as src, open(path + ".tmp", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.replace(path + ".tmp", path)
    if os.path.exists(path):
        _PRODUCT_VOCAB = Vocabulary.load_text(path)
        return _PRODUCT_VOCAB
    if not allow_build or _remaining() < 300:
        return None
    _PRODUCT_VOCAB = build_product_vocab(path)
    return _PRODUCT_VOCAB


def build_product_vocab(path: str):
    """Train the product vocabulary from both bench sequences' ORB
    descriptors and persist it as DBoW2 text."""
    from seqgen import make_sequence
    from irotavg_tpu.frontend import ORBExtractor
    from irotavg_tpu.frontend.prefetch import sample_descriptors
    from irotavg_tpu.placerec import train_vocabulary_flat

    ext = ORBExtractor(n_features=1000, n_levels=8)
    descs = []
    for seed, n in ((3, E2E_FRAMES), (5, INC_FRAMES)):
        frames, _, _ = make_sequence(n_frames=n, seed=seed, loop=True,
                                     passes=SEQ_PASSES, **SEQ_NOISE)
        descs.extend(sample_descriptors(frames, ext, stride=1, cap=1000))
    v = train_vocabulary_flat(descs, k=10, L=5, seed=0, iters=5)
    v.save_text(path + ".tmp")
    os.replace(path + ".tmp", path)
    return v


# bench workload knobs (shared by product_vocab & the product sections).
# SEQ_NOISE exercises the real-imagery paths the clean synthetic world
# skipped: photometric noise + blur (FAST two-threshold fallback,
# src/ORBExtractor.cpp:833-842) and lens distortion k1 != 0
# (undistortKeypoints, src/Frame.cpp:102-139).
SEQ_NOISE = dict(noise_sigma=6.0, blur_sigma=0.6, k1=-0.28, k2=0.07)
# incremental: lateral multi-pass sweep.  e2e: the RING world — a
# one-way two-lap orbit where odometry drift accumulates monotonically
# (reversing trajectories cancel their own drift: measured loop-closure
# gain was 0.8-1.2x there vs 7x on the ring).
SEQ_PASSES = 2
E2E_FRAMES = 240
E2E_LAPS = 2.0
INC_FRAMES = 200


def load_problem():
    from irotavg_tpu.solver import read_problem
    from irotavg_tpu.solver.init import init_mst

    if os.path.exists(PROBLEM):
        prob = read_problem(PROBLEM)
    else:  # fallback: synthetic problem of the same size
        from synth import make_problem

        p = make_problem(n=1832, extra_edges=3655 - 1831, noise_deg=2.0,
                         outlier_frac=0.1, seed=0)
        prob = {"edges": p["edges"], "QQ": p["QQ"],
                "Q": np.zeros((1832, 4)), "f": 0}
    f = max(prob["f"], 1)
    if prob["f"] == 0:
        prob["Q"][0] = [0, 0, 0, 1]
    Q0 = init_mst(prob["Q"], prob["QQ"], prob["edges"], f)
    return prob["edges"], prob["QQ"], Q0, f


def geo_deg(Qa, Qb):
    d = np.abs(np.sum(np.asarray(Qa) * np.asarray(Qb), axis=-1))
    return np.degrees(2.0 * np.arccos(np.clip(d, -1.0, 1.0)))


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------

def bench_headline():
    """Reference workload: solve ms vs scipy oracle + solution agreement."""
    import jax
    import jax.numpy as jnp
    import ref_impl as oracle
    from irotavg_tpu import so3
    from irotavg_tpu.solver import RotationGraph, l1ra, irls
    from irotavg_tpu.solver.l1ra import L1RAConfig
    from irotavg_tpu.solver.irls import IRLSConfig

    edges, QQ, Q0, f = load_problem()

    # --- baseline: scipy sparse direct-solve oracle on host CPU ---------
    A = oracle.make_A(len(Q0), f, edges)
    t0 = time.perf_counter()
    Q_b, l1_it_b, _ = oracle.l1ra(QQ, edges, A, Q0.copy(), f,
                                  max_iters=5, change_th=1e-3)
    Q_b, w_b, irls_it_b, _ = oracle.irls(QQ, edges, A, "Geman-McClure",
                                         np.deg2rad(5.0), Q_b, f,
                                         max_iters=50, change_th=1e-3)
    baseline_ms = (time.perf_counter() - t0) * 1e3
    Q_b = Q_b / np.linalg.norm(Q_b, axis=1, keepdims=True)

    # --- ours: jitted pipeline (f32 on the accelerator) -----------------
    # Timing methodology: (a) every timed call gets a slightly perturbed
    # input (1e-7 noise; same convergence behaviour), so no layer can
    # reuse a result, and (b) device time is isolated by running K solves
    # back-to-back inside ONE program (lax.while_loop with a traced trip
    # count) and differencing K=1 vs K=1+REPS, which cancels the dispatch
    # and fetch cost exactly.
    g = RotationGraph.create(edges, QQ, Q0, f=f, dtype=jnp.float32)
    l1_cfg = L1RAConfig(max_iters=5, change_th=1e-3)
    irls_cfg = IRLSConfig(max_iters=50, change_th=1e-3, backend="dense")

    @jax.jit
    def pipeline(g):
        Q1, l1_iters, _ = l1ra(g, l1_cfg)
        Q2, w, irls_iters, _ = irls(dataclasses.replace(g, Q=Q1), irls_cfg)
        return so3.qnormalize(Q2), w, l1_iters, irls_iters

    Qf, w, l1_it, irls_it = pipeline(g)  # compile + warmup
    Qf.block_until_ready()

    @jax.jit
    def pipeline_k(g, reps):
        def body(st):
            k, acc = st
            gk = dataclasses.replace(
                g, Q=g.Q + (k + 1).astype(g.Q.dtype) * 1e-7
            )
            Qk, _, _, _ = pipeline(gk)
            return k + 1, acc + Qk
        _, acc = jax.lax.while_loop(
            lambda st: st[0] < reps, body,
            (jnp.asarray(0, jnp.int32), jnp.zeros_like(g.Q)),
        )
        return acc

    def timed(reps, rep_id):
        # rep_id-dependent input defeats any identical-request caching
        gr = dataclasses.replace(
            g, Q=g.Q + jnp.asarray(rep_id * 1e-9, g.Q.dtype)
        )
        t0 = time.perf_counter()
        np.asarray(pipeline_k(gr, jnp.asarray(reps, jnp.int32)))
        return (time.perf_counter() - t0) * 1e3

    timed(1, 0)  # warmup
    t1 = [timed(1, 1 + r) for r in range(3)]
    tk = [timed(1 + REPS, 10 + r) for r in range(3)]
    # clamp: under timing noise the difference can go non-positive for
    # dispatch-dominated runs, which would flip vs_baseline negative
    ours_ms = max(float((np.median(tk) - np.median(t1)) / REPS), 1e-3)
    roundtrip_ms = float(max(np.median(t1) - ours_ms, 0.0))

    # solution quality: per-edge residual + per-rotation agreement with
    # the oracle's converged solution (gauge-aligned at the fixed node)
    res = so3.log_map(so3.delta_rel(g.edges, g.QQ, Qf))[:, 3]
    mean_res_deg = float(np.degrees(np.abs(np.asarray(res))).mean())
    res_b = so3.log_map(so3.delta_rel(edges, QQ, jnp.asarray(Q_b)))[:, 3]
    oracle_res_deg = float(np.degrees(np.abs(np.asarray(res_b))).mean())
    gdeg = geo_deg(np.asarray(Qf), Q_b)
    ok = (mean_res_deg < max(1.05 * oracle_res_deg, 0.05)
          and float(gdeg.max()) < 0.5)

    # Rate of the dominant kernel: the dense Cholesky factor+solve of the
    # n x n Laplacian inside every IRLS/Newton step, measured directly
    # (XLA's static cost model over-counts while_loops by max trip count).
    tflops = None
    try:
        from irotavg_tpu.solver.graph import laplacian_dense

        free = g.free_mask()
        coef = jnp.ones((g.m,), g.Q.dtype)
        L = laplacian_dense(g.edges, coef, free, g.edge_mask, g.n)

        reps = 50
        eye = jnp.eye(g.n, dtype=g.Q.dtype)

        @jax.jit
        def chol_many(L, rhs):
            # repetition stays on-device (one dispatch); the k-dependent
            # shift stops XLA hoisting the factorisation
            def body(k, X):
                Lk = L + (k.astype(L.dtype) * 1e-7) * eye
                return jax.scipy.linalg.cho_solve(
                    jax.scipy.linalg.cho_factor(Lk), X)
            return jax.lax.fori_loop(0, reps, body, rhs)

        rhs = jnp.ones((g.n, 3), g.Q.dtype)
        chol_many(L, rhs).block_until_ready()
        t0 = time.perf_counter()
        chol_many(L, rhs).block_until_ready()
        dt = (time.perf_counter() - t0) / reps
        n_ = g.n
        flops = n_ ** 3 / 3 + 2 * 3 * n_ ** 2  # factor + 3-rhs triangular
        tflops = flops / dt / 1e12
    except Exception:
        pass

    return {
        "value": round(ours_ms, 3),
        "vs_baseline": round(baseline_ms / ours_ms, 3),
        "baseline_ms": round(baseline_ms, 1),
        "dispatch_roundtrip_ms": round(roundtrip_ms, 1),
        "l1_iters": int(l1_it),
        "irls_iters": int(irls_it),
        "oracle_l1_iters": int(l1_it_b),
        "oracle_irls_iters": int(irls_it_b),
        "mean_residual_deg": round(mean_res_deg, 4),
        "oracle_residual_deg": round(oracle_res_deg, 4),
        "vs_oracle_geodesic_max_deg": round(float(gdeg.max()), 4),
        "vs_oracle_geodesic_mean_deg": round(float(gdeg.mean()), 5),
        "quality_ok": bool(ok),
        "chol_kernel_tflops": None if tflops is None else round(tflops, 2),
    }


def bench_large(n=50_000, m_extra=200_000):
    """50k-view quasi-global re-solve through the matrix-free CG path (f32).

    Warm start = GT perturbed by 3deg — the contract of the product path
    that reaches this size (`rotAvg(5e6)` after loop closure refines the
    already-near-optimal incremental state, src/IRotAvg.cpp:371-378).
    Noise 3deg + 10% outliers keeps the IRLS while_loop busy so this
    measures the loop, not dispatch.  Solution quality is cross-checked
    by an f64 CPU re-solve of the identical problem in a subprocess.
    """
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation as Rsc
    from synth import make_problem
    from irotavg_tpu import so3
    from irotavg_tpu.solver import RotationGraph, irls
    from irotavg_tpu.solver.irls import IRLSConfig

    p = make_problem(n=n, extra_edges=m_extra, noise_deg=3.0,
                     outlier_frac=0.1, seed=11)
    rng = np.random.default_rng(12)
    perturb = Rsc.from_rotvec(rng.normal(scale=np.radians(3.0), size=(n, 3)))
    Q0 = (perturb * Rsc.from_quat(p["Q_gt"])).as_quat()
    Q0[0] = p["Q_gt"][0]

    g = RotationGraph.create(p["edges"], p["QQ"], Q0, f=1,
                             dtype=jnp.float32)
    cfg = IRLSConfig(max_iters=100, change_th=1e-4, backend="cg",
                     cg_tol=1e-6, cg_maxiter=200)

    Q, w, iters, score = irls(g, cfg)  # compile + warmup
    Q.block_until_ready()
    times = []
    for r in range(3):
        # per-rep input perturbation: the backend short-circuits repeated
        # IDENTICAL calls (observed solve_s == 0.0 otherwise); 1e-7 on a
        # 3-deg-perturbed warm start does not change convergence
        gr = dataclasses.replace(g, Q=g.Q + jnp.float32((r + 1) * 1e-7))
        t0 = time.perf_counter()
        Q, w, iters, score = irls(gr, cfg)
        Q.block_until_ready()
        times.append(time.perf_counter() - t0)
    Qn = np.asarray(so3.qnormalize(Q))
    err = geo_deg(Qn, p["Q_gt"])
    out = {
        "n_views": n,
        "n_edges": int(len(p["edges"])),
        "solve_s": round(float(np.median(times)), 3),
        "irls_iters": int(iters),
        "converged": bool(int(iters) < cfg.max_iters),
        "final_score": float(np.asarray(score)),
        "mean_err_vs_gt_deg": round(float(err.mean()), 3),
        "backend": "cg_f32",
    }

    # f64 cross-check: identical problem + config re-solved at float64 on
    # the host CPU (subprocess).
    budget = _remaining() - 30
    if budget < 60:
        out["f64_check"] = {"skipped": "budget"}
        return out
    try:
        import subprocess
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".npy", delete=False) as fh:
            np.save(fh, Qn)
            qpath = fh.name
        env = os.environ.copy()
        env.pop("JAX_PLATFORMS", None)
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "bench.py"),
             "--crosscheck-f64", qpath, str(n), str(m_extra)],
            capture_output=True, text=True, timeout=min(budget, 900),
            env=env,
        )
        out["f64_check"] = json.loads(r.stdout.strip().splitlines()[-1])
    except Exception as e:
        out["f64_check"] = {"error": f"{type(e).__name__}: {e}"}
    return out


def crosscheck_f64_main(qpath, n, m_extra):
    """Subprocess entry: f64 CPU re-solve of bench_large's exact problem."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation as Rsc
    from synth import make_problem
    from irotavg_tpu import so3
    from irotavg_tpu.solver import RotationGraph, irls
    from irotavg_tpu.solver.irls import IRLSConfig

    p = make_problem(n=n, extra_edges=m_extra, noise_deg=3.0,
                     outlier_frac=0.1, seed=11)
    rng = np.random.default_rng(12)
    perturb = Rsc.from_rotvec(rng.normal(scale=np.radians(3.0), size=(n, 3)))
    Q0 = (perturb * Rsc.from_quat(p["Q_gt"])).as_quat()
    Q0[0] = p["Q_gt"][0]
    g = RotationGraph.create(p["edges"], p["QQ"], Q0, f=1,
                             dtype=jnp.float64)
    cfg = IRLSConfig(max_iters=100, change_th=1e-4, backend="cg",
                     cg_tol=1e-10, cg_maxiter=400)
    Q, w, iters, score = irls(g, cfg)
    Q64 = np.asarray(so3.qnormalize(Q))
    Q32 = np.load(qpath)
    err64 = geo_deg(Q64, p["Q_gt"])
    delta = geo_deg(Q64, Q32)
    print(json.dumps({
        "irls_iters": int(iters),
        "mean_err_vs_gt_deg": round(float(err64.mean()), 4),
        "vs_f32_geodesic_mean_deg": round(float(delta.mean()), 4),
        "vs_f32_geodesic_p99_deg": round(float(np.percentile(delta, 99)), 4),
        # the max is dominated by outlier-edge-only nodes whose incident
        # Geman-McClure weights all collapse: their rotation is weakly
        # determined — mean/p99 are the agreement signal
        "vs_f32_geodesic_max_deg": round(float(delta.max()), 4),
    }))


def bench_windows(W=384, reps=6):
    """Batched independent window solves — the multi-sequence serving shape.

    One incremental `rotAvg(10)` window (n~14, m~30) cannot fill the
    device; `engine.batched` vmaps W of them into one dispatch (batched
    Cholesky).
    Baseline: the scipy oracle solving the same windows one by one — the
    direct analogue of the reference running its SuiteSparse window solve
    per sequence (ral/l1_irls.cpp:536-556).

    Adds the saturation story (BASELINE config 1-2): a sweep of the
    batched Cholesky kernel over W until solves/s stops scaling, with the
    measured TFLOP/s at each point and the knee reported.
    """
    import jax
    import jax.numpy as jnp
    import ref_impl as oracle
    from scipy.spatial.transform import Rotation as Rsc
    from synth import make_problem
    from irotavg_tpu.engine.batched import batched_window_solver, pack_windows

    rng = np.random.default_rng(21)
    problems = []
    gts = []
    for k in range(W):
        nk = int(rng.integers(12, 16))
        p = make_problem(n=nk, extra_edges=nk * 2, noise_deg=2.0,
                         outlier_frac=0.1, seed=500 + k)
        pert = Rsc.from_rotvec(rng.normal(scale=np.radians(3.0),
                                          size=(nk, 3)))
        Q0 = (pert * Rsc.from_quat(p["Q_gt"])).as_quat()
        f = 2
        Q0[:f] = p["Q_gt"][:f]
        problems.append((p["edges"].astype(np.int32), p["QQ"], Q0, f))
        gts.append(p["Q_gt"])

    m_pad, n_pad = 64, 16
    packed = pack_windows(problems, m_pad, n_pad, np.float32)
    solve = batched_window_solver(m_pad, n_pad, 100, 100,
                                  float(np.radians(5.0)), 1e-3,
                                  "Geman-McClure", "float32")
    dev = [jnp.asarray(a) for a in packed]
    out = solve(*dev)
    out[0].block_until_ready()           # compile + warmup

    def run_once(eps):
        # input perturbation defeats identical-request short-circuiting
        return solve(dev[0], dev[1], dev[2] + eps, dev[3], dev[4], dev[5])

    # best-of-3 timed blocks: the minimum is the least-contended
    # observation of a fixed dispatch stream
    blocks = []
    for b in range(3):
        t0 = time.perf_counter()
        outs = [run_once(jnp.float32((b * reps + r + 1) * 1e-7))
                for r in range(reps)]
        for o in outs:
            o[0].block_until_ready()     # queue all, block once
        blocks.append(time.perf_counter() - t0)
    dt = min(blocks)
    ours_wps = W * reps / dt

    Qf, wgt, iters, score = jax.device_get(outs[-1])

    # oracle: sequential scipy solves of the first chunk, extrapolated
    n_oracle = 24
    t0 = time.perf_counter()
    for k in range(n_oracle):
        e, qq, q0, f = problems[k]
        A = oracle.make_A(len(q0), f, e)
        Q1, _, _ = oracle.l1ra(qq, e, A, q0.copy(), f,
                               max_iters=100, change_th=1e-3)
        oracle.irls(qq, e, A, "Geman-McClure", np.deg2rad(5.0), Q1, f,
                    max_iters=100, change_th=1e-3)
    oracle_wps = n_oracle / (time.perf_counter() - t0)

    # quality: batched solutions against GT
    errs = []
    for k in range(W):
        nk = len(problems[k][2])
        errs.append(geo_deg(Qf[k, :nk], gts[k]).mean())
    res = {
        "windows": W,
        "window_shape": {"m_pad": m_pad, "n_pad": n_pad},
        "windows_per_s": round(ours_wps, 1),
        "windows_per_s_median_block": round(
            W * reps / float(np.median(blocks)), 1),
        "oracle_windows_per_s": round(oracle_wps, 1),
        "vs_oracle": round(ours_wps / oracle_wps, 1),
        "batch_ms_per_dispatch": round(1e3 * dt / reps, 2),
        "mean_err_vs_gt_deg": round(float(np.mean(errs)), 3),
        "mean_irls_iters": round(float(iters.mean()), 1),
    }

    # --- saturation sweep of the batched Cholesky kernel ----------------
    # The hot op of every window solve is the batched n_pad x n_pad
    # factor+solve; sweep the batch until solves/s flattens (the knee =
    # the serving capacity of one chip at this window shape).
    if _remaining() > 90:
        sweep = {}
        best = (0.0, 0)
        kreps = 40
        for Wk in (384, 1536, 6144, 24576):
            if _remaining() < 45:
                break

            def one_solve(Lk, xk):
                cf = jax.scipy.linalg.cho_factor(Lk)
                return jax.scipy.linalg.cho_solve(cf, xk)

            @jax.jit
            def chol_batch(Ls, rhs):
                def body(k, X):
                    Lk = Ls + (k.astype(Ls.dtype) * 1e-7
                               ) * jnp.eye(Ls.shape[-1], dtype=Ls.dtype)
                    return jax.vmap(one_solve)(Lk, X)
                return jax.lax.fori_loop(0, kreps, body, rhs)

            rngk = np.random.default_rng(33)
            Amat = rngk.normal(size=(Wk, n_pad, n_pad)).astype(np.float32)
            Ls = jnp.asarray(Amat @ np.swapaxes(Amat, 1, 2)
                             + 4.0 * np.eye(n_pad, dtype=np.float32))
            rhs = jnp.ones((Wk, n_pad, 3), jnp.float32)
            chol_batch(Ls, rhs).block_until_ready()
            t0 = time.perf_counter()
            chol_batch(Ls, rhs).block_until_ready()
            dtk = (time.perf_counter() - t0) / kreps
            flops = Wk * (n_pad ** 3 / 3 + 2 * 3 * n_pad ** 2)
            solves_s = Wk / dtk
            sweep[str(Wk)] = {
                "chol_solves_per_s": round(solves_s, 0),
                "tflops": round(flops / dtk / 1e12, 3),
            }
            if solves_s > best[0]:
                best = (solves_s, Wk)
        res["chol_sweep"] = sweep
        res["chol_knee_W"] = best[1]
        res["chol_knee_solves_per_s"] = round(best[0], 0)
    return res


def bench_vocab():
    """Place-recognition at production scale.

    Part 1 (the true-scale artifact): a complete k=10/L=6 tree — ~1.11M
    nodes, the exact shape of the shipping ORB-SLAM vocabulary
    (TemplatedVocabulary.h:1337-1424) — written as DBoW2 text (~150 MB)
    and parsed back through the native C parser, timing both directions.
    Part 2: batched descent + inverted-file cascade timings on the 100k-
    word tree (16 frames x 2000 descriptors per dispatch, 500-view db).
    """
    import tempfile

    from irotavg_tpu.placerec.bow import bow_score
    from irotavg_tpu.placerec.database import ViewDatabase
    from irotavg_tpu.placerec.vocabulary import (
        Vocabulary, make_random_vocabulary,
    )

    out = {}
    # -- part 1: k=10/L=6 text round trip at the 145 MB production size --
    if _remaining() > 240:
        v6 = make_random_vocabulary(k=10, L=6, seed=7)
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "vocab_1m.txt")
            t0 = time.perf_counter()
            v6.save_text(p)
            save_s = time.perf_counter() - t0
            size_mb = os.path.getsize(p) / 1e6
            from irotavg_tpu import native as native_mod

            t0 = time.perf_counter()
            parsed = native_mod.parse_vocab_text(p)
            raw_parse_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            v6b = Vocabulary.load_text(p)
            load_s = time.perf_counter() - t0
            assert v6b.n_words == v6.n_words == 10 ** 6
            del parsed
        out["production_scale"] = {
            "k": 10, "L": 6, "n_words": int(v6.n_words),
            "n_nodes": int(len(v6.children)),
            "text_mb": round(size_mb, 1),
            "save_text_s": round(save_s, 2),
            # raw C parse of the text (validates the ~1 s/145 MB design
            # claim, native/native.cpp) vs the full load incl. children
            # table + device upload
            "native_parse_s": round(raw_parse_s, 2),
            "load_total_s": round(load_s, 2),
        }
        del v6, v6b
    else:
        out["production_scale"] = {"skipped": "budget"}

    # -- part 2: descent + cascade on the 100k-word tree ------------------
    v = make_random_vocabulary(k=10, L=5, seed=7)
    rng = np.random.default_rng(5)
    B, N = 16, 2000
    descs = rng.integers(0, 2 ** 32, (B, N, 8), dtype=np.uint32)
    res = v.transform_batch(descs)              # compile + warmup
    t0 = time.perf_counter()
    reps = 4
    for r in range(reps):
        res = v.transform_batch(descs ^ np.uint32(r + 1))
    transform_s = (time.perf_counter() - t0) / reps
    bows = [b for b, _ in res]

    db = ViewDatabase()
    for i in range(500):
        db.add(i, bows[i % B])
    t0 = time.perf_counter()
    n_q = 32
    for q in range(n_q):
        db.detect_loop_candidates(
            query_id=10_000 + q, bow=bows[q % B], connected=set(),
            min_score=0.0, covisibility_fn=lambda i, n: [],
            score_fn=bow_score,
        )
    query_ms = (time.perf_counter() - t0) / n_q * 1e3
    out.update({
        "k": 10, "L": 5, "n_words": int(v.n_words),
        "transform_frames_per_s": round(B / transform_s, 1),
        "transform_desc_per_s": round(B * N / transform_s, 0),
        "db_views": 500,
        "cascade_query_ms": round(query_ms, 2),
    })
    return out


def bench_scaling():
    """1/2/4/8-device scaling artifact (subprocess on the virtual CPU
    mesh; work_conservation ~1.0, not wall speedup, is the healthy signal
    there — see irotavg_tpu/parallel/scaling_probe.py).  Runs EARLY in
    the section order, before the host-heavy sections (seqgen rendering,
    scipy oracles, the f64 subprocess) can contend with it — the r04
    probe ran last and its work-conservation drifted 0.86 -> 0.69 purely
    from load."""
    import subprocess

    budget = min(420.0, _remaining() - 120)
    if budget < 120:
        return {"skipped": "budget"}
    env = os.environ.copy()
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-m", "irotavg_tpu.parallel.scaling_probe",
         "--platform", "cpu",
         "--sizes", "20000:80000,50000:200000",
         "--devices", "1,2,4,8", "--reps", "5"],
        capture_output=True, text=True, timeout=budget, env=env, cwd=REPO,
    )
    if r.returncode != 0:
        return {"error": r.stderr.strip()[-300:]}
    return json.loads(r.stdout.strip().splitlines()[-1])


def bench_incremental(n_frames=None, gt_every=20, loop_closure=True):
    """The reference's actual workload: per-frame incremental SLAM.

    Drives the full engine — Frame (batched look-ahead extraction + BoW)
    -> process_frame -> loop closure (candidate cascade -> consistency ->
    BoW match -> verify -> connect) -> rotAvg(10), GT fix every
    ``gt_every`` frame ids and loop closures each followed by a
    quasi-global re-solve — mirroring the main loop of
    src/IRotAvg.cpp:251-392 with its per-frame timing observable
    (:382-383).  fps_steady is the back half of the run, once the
    bucketed executables are compiled.  The vocabulary is the >=100k-word
    product tree (production scale, not a toy k=8/L=3).
    """
    from seqgen import make_sequence
    from irotavg_tpu import so3
    from irotavg_tpu.engine.viewgraph import FrameConnectionError, ViewGraph
    from irotavg_tpu.frontend import Camera, FramePrefetcher, ORBExtractor

    n_frames = n_frames or INC_FRAMES
    # out-and-back trajectory (stays inside the textured scene for the
    # whole run; the return leg revisits the start so loop closure has
    # real work), with photometric noise + lens distortion (SEQ_NOISE)
    frames, K, R_gt = make_sequence(n_frames=n_frames, seed=5, loop=True,
                                    passes=SEQ_PASSES, **SEQ_NOISE)
    cam = Camera(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                 width=640, height=480,
                 k1=SEQ_NOISE["k1"], k2=SEQ_NOISE["k2"])
    ext = ORBExtractor(n_features=1000, n_levels=8)
    vg = ViewGraph(cam, min_matches=50)

    vocab = None
    vocab_words = 0
    if loop_closure:
        t0 = time.perf_counter()
        vocab = product_vocab()
        vocab_s = time.perf_counter() - t0
        if vocab is None:   # cache gone AND budget gone: small fallback
            from irotavg_tpu.frontend.prefetch import sample_descriptors
            from irotavg_tpu.placerec import train_vocabulary

            sample = sample_descriptors(frames, ext, stride=10, cap=400)
            vocab = train_vocabulary(sample, k=8, L=3, seed=0)
        vocab_words = vocab.n_words
    pf = FramePrefetcher(frames, ext, cam, batch=8, vocab=vocab)

    if vocab is not None:
        # Warm the loop-closure program on same-capacity frames BEFORE
        # the timed loop: a program's first call compiles, a one-time
        # cost that belongs with the other compiles (fps vs fps_steady),
        # not in the steady half.
        wpf = FramePrefetcher(frames[:2], ext, cam, batch=8, vocab=vocab)
        wvg = ViewGraph(cam, min_matches=50)
        try:
            wvg.process_frame(wpf.frame(0))
            wvg.frames.append(wpf.frame(1))
            wvg.ra.add_view()
            wvg.close_loop(1, 0, min_matches=150)
        except Exception:
            pass                     # warmup only — failures are harmless

    stage = {"frame_s": 0.0, "process_s": 0.0, "loop_s": 0.0,
             "rotavg_s": 0.0}
    rotavg_ms = []
    kept = []
    view_ids = []   # view index per kept frame: a FrameConnectionError
    dropped = 0     # frame is still appended to vg.frames/ra, so slicing
                    # ra.Q[:num_views] would misalign with `kept`
    loop_edges = 0
    half_mark = None
    t_start = time.perf_counter()
    for i in range(n_frames):
        if i == n_frames // 2:
            half_mark = time.perf_counter()
        t0 = time.perf_counter()
        f = pf.frame(i)
        stage["frame_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            ok = vg.process_frame(f, win_size=4)
        except FrameConnectionError:
            # the reference aborts the whole run here; a benchmark is more
            # useful skipping the frame and reporting the count
            dropped += 1
            ok = False
        stage["process_s"] += time.perf_counter() - t0
        if not ok:
            continue
        kept.append(i)
        view_ids.append(vg.num_views - 1)
        view_id = vg.num_views - 1

        loop_new = False
        if vocab is not None:
            t0 = time.perf_counter()
            cands = vg.detect_loop_candidates(view_id)
            consistent = vg.check_loop_consistency(cands) if cands else []
            for cand in consistent:
                if vg.close_loop(view_id, cand, min_matches=150):
                    loop_edges += 1
                    loop_new = True
            vg.add_to_database(view_id)
            stage["loop_s"] += time.perf_counter() - t0

        fixed = False
        if i % gt_every == 0:
            q_gt = np.asarray(so3.rotmat_to_quat(R_gt[i]))
            vg.fix_pose(vg.num_views - 1, q_gt)
            fixed = True
        t0 = time.perf_counter()
        if fixed or loop_new:
            vg.rot_avg(5_000_000)        # src/IRotAvg.cpp:371-378
        else:
            vg.rot_avg(10)               # the app's either/or (:380)
        dt = time.perf_counter() - t0
        stage["rotavg_s"] += dt
        rotavg_ms.append(dt * 1e3)
    total_s = time.perf_counter() - t_start
    steady_s = time.perf_counter() - half_mark

    q_est = vg.ra.Q[view_ids]
    q_gt = np.stack([np.asarray(so3.rotmat_to_quat(R_gt[i])) for i in kept])
    qa = so3.qmul(q_est, np.tile(so3.qinv_flipw(q_est[0]), (len(q_est), 1)))
    qb = so3.qmul(q_gt, np.tile(so3.qinv_flipw(q_gt[0]), (len(q_gt), 1)))
    err = np.degrees(np.asarray(so3.qgeodesic(so3.qnormalize(qa), qb)))
    return {
        "frames": n_frames,
        "keyframes": len(kept),
        "dropped_frames": dropped,
        "gt_fixes": len([i for i in kept if i % gt_every == 0]),
        "loop_edges": loop_edges,
        "vocab_words": vocab_words,
        "fps": round(n_frames / total_s, 2),
        "fps_steady": round((n_frames - n_frames // 2) / steady_s, 2),
        "keyframes_per_s": round(len(kept) / total_s, 2),
        "stage_s": {k: round(v, 2) for k, v in stage.items()},
        "rotavg_ms_p50": round(float(np.median(rotavg_ms)), 1),
        "rotavg_ms_p90": round(float(np.percentile(rotavg_ms, 90)), 1),
        "rotation_rmse_deg": round(float(np.sqrt((err ** 2).mean())), 4),
        "rotation_max_err_deg": round(float(err.max()), 4),
    }


def bench_e2e(n_frames=None):
    """Offline SLAM pipeline on a drift-accumulating synthetic sequence.

    Measured WITH loop closure (the reference's signature capability,
    src/IRotAvg.cpp:295-353) using the >=100k-word product vocabulary,
    and once WITHOUT to measure the loop-closure accuracy payoff.  The
    sequence carries photometric noise + lens distortion (SEQ_NOISE), so
    the undistortKeypoints (k1 != 0) and FAST two-threshold fallback
    paths run in-product.  No GT anchoring here — drift must accumulate
    for loop edges to have something to correct.
    """
    from scipy.spatial.transform import Rotation as Rsc
    from seqgen import make_ring_sequence
    from irotavg_tpu.frontend.camera import Camera
    from irotavg_tpu.frontend.orb import ORBExtractor
    from irotavg_tpu.pipeline.offline import run_offline

    n_frames = n_frames or E2E_FRAMES
    frames, K, R_gt = make_ring_sequence(n_frames=n_frames, seed=3,
                                         laps=E2E_LAPS, **SEQ_NOISE)
    cam = Camera(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                 width=640, height=480,
                 k1=SEQ_NOISE["k1"], k2=SEQ_NOISE["k2"])
    ext = ORBExtractor(n_features=1000, n_levels=8)

    t0 = time.perf_counter()
    vocab = product_vocab()
    vocab_s = time.perf_counter() - t0

    e2e_batch = int(os.environ.get("E2E_BATCH", "8"))
    e2e_chunk = int(os.environ.get("E2E_CHUNK", "8"))

    def once(v):
        return run_offline(frames, cam, ext, vocab=v, batch=e2e_batch,
                           chunk=e2e_chunk, min_matches=40,
                           refine_iters=int(os.environ.get(
                               "E2E_REFINE_ITERS", "10")))

    res = once(vocab)               # cold: includes every compile
    cold_s = res.stats["total_s"]
    res = once(vocab)               # warm: steady-state, full product
    total_s = res.stats["total_s"]

    def rmse(r):
        Rs = Rsc.from_quat(np.array(r.Q))
        gt = Rsc.from_matrix(np.array(R_gt[r.keyframes]))
        rel = (Rs[0].inv() * Rs).inv() * (gt[0].inv() * gt)
        err = rel.magnitude() * 180.0 / np.pi
        return (round(float(np.sqrt((err ** 2).mean())), 4),
                round(float(err.max()), 4))

    rmse_loop, max_loop = rmse(res)

    out = {
        "frames": n_frames,
        "keyframes": len(res.keyframes),
        "edges": int(len(res.edges)),
        "loop_edges": int(res.loop_edges),
        "loop_candidate_pairs": int(res.stats.get("loop_candidate_pairs", 0)),
        "vocab_words": 0 if vocab is None else int(vocab.n_words),
        "vocab_load_s": round(vocab_s, 2),
        "fps_warm": round(n_frames / total_s, 2),
        "fps_cold": round(n_frames / cold_s, 2),
        "stage_s": {k: round(v, 3) for k, v in res.stats.items()
                    if k.endswith("_s")},
        "irls_iters": int(res.stats.get("irls_iters", -1)),
        "rotation_rmse_deg": rmse_loop,
        "rotation_max_err_deg": max_loop,
    }

    # per-edge relative-rotation error vs GT: front-end accuracy isolated
    # from trajectory drift
    kfs = np.asarray(res.keyframes)
    Rg = np.array(R_gt)
    R_rel_gt = Rg[kfs[res.edges[:, 1]]] @ np.swapaxes(
        Rg[kfs[res.edges[:, 0]]], 1, 2)
    q_rel_gt = Rsc.from_matrix(R_rel_gt).as_quat()
    edge_err = geo_deg(np.array(res.QQ), q_rel_gt)
    lm = res.loop_mask
    out["edge_err_mean_deg"] = round(float(edge_err[~lm].mean()), 4)
    out["edge_err_p90_deg"] = round(
        float(np.percentile(edge_err[~lm], 90)), 4)
    if lm.any():
        out["loop_edge_err_mean_deg"] = round(float(edge_err[lm].mean()), 4)

    # loop-closure payoff: the same warm pipeline without the vocabulary
    if _remaining() > 60:
        res_nl = once(None)
        rmse_nl, max_nl = rmse(res_nl)
        out["fps_warm_noloop"] = round(
            n_frames / res_nl.stats["total_s"], 2)
        out["rotation_rmse_deg_noloop"] = rmse_nl
        out["rotation_max_err_deg_noloop"] = max_nl
        out["loop_gain"] = round(rmse_nl / max(rmse_loop, 1e-9), 2)
    else:
        out["rotation_rmse_deg_noloop"] = None
    return out


# ---------------------------------------------------------------------------
# compact projections (keep the merged stdout line under the tail cap)
# ---------------------------------------------------------------------------

def _compact_of(name: str, full: dict) -> dict:
    if "error" in full or "skipped" in full:
        return {k: v for k, v in full.items() if k in ("error", "skipped")}
    if name == "e2e":
        return {
            "fps_warm": full["fps_warm"], "fps_cold": full["fps_cold"],
            "rmse_deg": full["rotation_rmse_deg"],
            "rmse_noloop_deg": full.get("rotation_rmse_deg_noloop"),
            "loop_gain": full.get("loop_gain"),
            "loop_edges": full["loop_edges"],
            "vocab_words": full["vocab_words"],
        }
    if name == "incremental":
        return {
            "fps": full["fps"], "fps_steady": full["fps_steady"],
            "rmse_deg": full["rotation_rmse_deg"],
            "loop_edges": full["loop_edges"],
            "rotavg_ms_p50": full["rotavg_ms_p50"],
            "vocab_words": full["vocab_words"],
        }
    if name == "windows":
        return {
            "wps": full["windows_per_s"], "vs_oracle": full["vs_oracle"],
            "err_deg": full["mean_err_vs_gt_deg"],
            "chol_knee_W": full.get("chol_knee_W"),
            "chol_knee_solves_per_s": full.get("chol_knee_solves_per_s"),
        }
    if name == "vocab":
        ps = full.get("production_scale", {})
        return {
            "k10L6_words": ps.get("n_words"),
            "k10L6_text_mb": ps.get("text_mb"),
            "k10L6_parse_s": ps.get("native_parse_s"),
            "desc_per_s": full.get("transform_desc_per_s"),
            "cascade_ms": full.get("cascade_query_ms"),
        }
    if name == "large":
        return {
            "n": full["n_views"], "solve_s": full["solve_s"],
            "converged": full["converged"],
            "err_deg": full["mean_err_vs_gt_deg"],
        }
    if name == "scaling":
        comp = {}
        for label, size in full.get("by_size", {}).items():
            wc = size.get("by_devices", {}).get("8", {}).get(
                "work_conservation")
            comp[f"wc8_{label}"] = wc
        return comp or {k: v for k, v in full.items() if k == "error"}
    return {}


# minimum seconds a section needs (warm cache) before it's worth starting
_FLOOR = {
    "scaling": 150, "incremental": 150, "e2e": 150,
    "windows": 60, "vocab": 45, "large": 60,
}


def main():
    _install_watchdog()
    # even a device that fails to start must leave a parseable record
    try:
        from irotavg_tpu.utils.cache import enable_persistent_cache

        enable_persistent_cache()
        import jax

        platform = jax.devices()[0].platform
    except Exception as e:
        platform = f"error:{type(e).__name__}"
    _COMPACT.update({
        "metric": "batch_ravg_solve_ms_m3655_n1832",
        "unit": "ms",
        "platform": platform,
        "budget_s": _BUDGET,
        "detail": "BENCH_FULL.json",
        "skipped": [],
    })
    _FULL.update({k: _COMPACT[k] for k in
                  ("metric", "unit", "platform", "budget_s")})

    # headline first: it carries the metric line's required fields
    try:
        head = bench_headline()
        _COMPACT["value"] = head["value"]
        _COMPACT["vs_baseline"] = head["vs_baseline"]
        _COMPACT["quality_ok"] = head["quality_ok"]
        _FULL["headline"] = head
        _FULL["value"] = head["value"]
        _FULL["vs_baseline"] = head["vs_baseline"]
    except Exception as e:
        _COMPACT["value"] = -1.0
        _COMPACT["vs_baseline"] = 0.0
        _FULL["headline"] = {"error": f"{type(e).__name__}: {e}"}
    _emit()

    _COMPACT["sections"] = {}
    for name, fn in (("scaling", bench_scaling),
                     ("incremental", bench_incremental),
                     ("e2e", bench_e2e),
                     ("windows", bench_windows),
                     ("vocab", bench_vocab),
                     ("large", bench_large)):
        if _remaining() < _FLOOR[name]:
            _COMPACT["skipped"].append(name)
            _FULL[name] = {"skipped": "budget",
                           "remaining_s": round(_remaining(), 1)}
            _emit()
            continue
        try:
            full = fn()
        except Exception as e:  # a failed section must not sink the line
            full = {"error": f"{type(e).__name__}: {e}"}
        _FULL[name] = full
        _COMPACT["sections"][name] = _compact_of(name, full)
        _emit()
    _emit(final=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--crosscheck-f64":
        crosscheck_f64_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    elif len(sys.argv) > 1 and sys.argv[1] == "--build-vocab":
        # development: (re)build the product vocabulary into the cache
        from irotavg_tpu.utils.cache import enable_persistent_cache

        enable_persistent_cache()
        p = os.path.join(_cache_dir(), "product_vocab_k10_L5_v1.txt")
        t0 = time.perf_counter()
        v = build_product_vocab(p)
        print(json.dumps({"n_words": v.n_words, "path": p,
                          "build_s": round(time.perf_counter() - t0, 1)}))
    elif len(sys.argv) > 1 and sys.argv[1].startswith("--only="):
        # development: run one section, e.g. --only=windows
        name = sys.argv[1].split("=", 1)[1]
        from irotavg_tpu.utils.cache import enable_persistent_cache

        enable_persistent_cache()
        fn = {"headline": bench_headline, "windows": bench_windows,
              "large": bench_large, "e2e": bench_e2e,
              "incremental": bench_incremental, "vocab": bench_vocab,
              "scaling": bench_scaling}[name]
        print(json.dumps({name: fn()}))
    else:
        main()
