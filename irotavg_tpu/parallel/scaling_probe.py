"""Device-scaling probe for the edge-sharded distributed solver.

Runs the SAME fixed-work distributed IRLS solve (fixed outer iterations,
fixed CG budget, convergence tests disabled) over 1/2/4/8-device meshes
and reports wall time per device count.  This is the scaling artifact for
BASELINE.md config 5; the serial counterpart it replaces is the
single-threaded SuiteSparse factorisation (ral/l1_irls.cpp:536-556).

Interpretation depends on where it runs:

* On real devices (GPUs of one host), ``t_D`` falling near-linearly is the
  scaling-efficiency claim itself.
* On a virtual CPU mesh (``--xla_force_host_platform_device_count``),
  all "devices" timeshare the same physical cores, so wall time CANNOT
  drop with D.  What the curve shows there is the *overhead* of the
  distributed program: total work is constant (the edge shards sum to
  the same m), so ``t_D / t_1`` measures everything the sharding adds —
  psum collectives, per-shard dispatch, partition bookkeeping.
  ``t_D ≈ t_1`` (work conservation ~1) is the necessary condition for
  near-linear scaling on hardware where the shards really run in
  parallel; large ``t_D / t_1`` would expose a collective bottleneck.

Usage (as spawned by bench.py):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python -m irotavg_tpu.parallel.scaling_probe --platform cpu \
        --n 50000 --extra-edges 200000 --devices 1,2,4,8

Prints one JSON object to stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None,
                    help="force a jax platform, e.g. 'cpu' for the "
                         "virtual-device mesh")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--extra-edges", type=int, default=200_000)
    ap.add_argument("--sizes", default=None,
                    help="comma list of n:extra_edges pairs; overrides "
                         "--n/--extra-edges and reports one block per "
                         "size (small vs large separates collective "
                         "overhead from CG work)")
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--outer-iters", type=int, default=6)
    ap.add_argument("--cg-iters", type=int, default=40)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import numpy as np

    avail = len(jax.devices())
    counts = [int(d) for d in args.devices.split(",") if int(d) <= avail]
    if args.sizes:
        sizes = [tuple(int(v) for v in s.split(":"))
                 for s in args.sizes.split(",")]
    else:
        sizes = [(args.n, args.extra_edges)]

    out = {
        "platform": jax.devices()[0].platform,
        "physical_cores_note": (
            "virtual CPU devices timeshare host cores; see module doc"
            if jax.devices()[0].platform == "cpu" else ""
        ),
        "outer_iters": args.outer_iters,
        "cg_iters_per_outer": args.cg_iters,
        "reps": args.reps,
        "by_size": {},
    }
    for n, m_extra in sizes:
        out["by_size"][f"{n // 1000}k"] = _probe_one(
            n, m_extra, counts, args, jax, np
        )
    if len(sizes) == 1:   # pre-round-5 flat layout, kept for tooling
        out.update(next(iter(out["by_size"].values())))
    json.dump(out, sys.stdout)
    print()


def _probe_one(n, m_extra, counts, args, jax, np):
    """One fixed-work scaling curve at a given problem size."""
    import time as _time

    from irotavg_tpu.parallel.sharded import (
        make_graph_mesh, shard_graph, sharded_irls,
    )
    from irotavg_tpu.solver.graph import RotationGraph
    from irotavg_tpu.solver.irls import IRLSConfig

    # synthetic problem (same generator family as tests/synth.py, inlined
    # so the probe is importable outside the test tree)
    rng = np.random.default_rng(11)
    from scipy.spatial.transform import Rotation as Rsc

    R_gt = Rsc.from_rotvec(rng.normal(scale=0.5, size=(n, 3)))
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    ii = rng.integers(0, n - 3, m_extra)
    jj = ii + rng.integers(2, 50, m_extra)
    jj = np.minimum(jj, n - 1)
    edges = np.concatenate([chain, np.stack([ii, jj], 1)]).astype(np.int32)
    Rrel = R_gt[edges[:, 1]] * R_gt[edges[:, 0]].inv()
    noise = Rsc.from_rotvec(rng.normal(scale=np.radians(3.0),
                                       size=(len(edges), 3)))
    QQ = (noise * Rrel).as_quat()
    pert = Rsc.from_rotvec(rng.normal(scale=np.radians(3.0), size=(n, 3)))
    Q0 = (pert * R_gt).as_quat()
    Q0[0] = R_gt[0].as_quat()

    # fixed work: convergence checks off (change_th=0 -> run max_iters;
    # cg_tol=0 -> run cg_maxiter) so every device count executes an
    # identical instruction stream
    cfg = IRLSConfig(max_iters=args.outer_iters, change_th=0.0,
                     backend="cg", cg_tol=0.0, cg_maxiter=args.cg_iters)

    results = {}
    raw = {}        # unrounded (median, min) seconds: ratios use these
    lcm = max(counts)
    m_pad = ((len(edges) + lcm - 1) // lcm) * lcm
    g0 = RotationGraph.create(edges, QQ, Q0, f=1,
                              dtype="float32").pad_to(m_pad, n)

    for d in counts:
        mesh = make_graph_mesh(d)
        g = shard_graph(g0, mesh)
        solve = sharded_irls(mesh, cfg)
        Q, w, iters, score = solve(g)   # compile + warmup
        Q.block_until_ready()
        times = []
        for _ in range(args.reps):
            t0 = _time.perf_counter()
            Q, w, iters, score = solve(g)
            Q.block_until_ready()
            times.append(_time.perf_counter() - t0)
        raw[d] = (float(np.median(times)), float(np.min(times)))
        results[d] = {
            "solve_s": round(raw[d][0], 3),
            "solve_s_min": round(raw[d][1], 3),
            "iters": int(iters),
        }

    # work conservation from per-count MINIMA: the minimum over reps is
    # the least-contended observation of a fixed instruction stream, so
    # min-ratios isolate sharding overhead from background host load
    # (the medians drifted 0.86 -> 0.69 between r03 and r04 purely from
    # co-running bench sections)
    t1, t1_min = raw[counts[0]]
    on_cpu_mesh = jax.devices()[0].platform == "cpu"
    for d in counts:
        td, td_min = raw[d]
        results[d]["speedup_vs_1dev"] = round(t1 / td, 3)
        results[d]["parallel_efficiency"] = round(t1 / (d * td), 3)
        if on_cpu_mesh:
            # constant-work ratio: ~1.0 means the distributed program adds
            # no overhead over the 1-device run (see module docstring).
            # Only meaningful on the timeshared virtual mesh — on real
            # chips t1/td is genuine speedup.
            results[d]["work_conservation"] = round(t1_min / td_min, 3)

    out = {
        "n_views": n,
        "n_edges": int(len(edges)),
        "by_devices": {str(k): v for k, v in results.items()},
    }
    if on_cpu_mesh:
        # Attribute the conservation deficit.  Node state is REPLICATED
        # (see module doc: the design trades a tiny duplicated O(n)
        # vector workload for psum-only collectives), so on a C-core
        # host, D virtual devices duplicate that work (D-1) extra times
        # with only C cores to absorb it — a deficit that is a property
        # of the VIRTUAL mesh, not of the program: on real chips each
        # device's copy runs on its own device concurrently, at zero wall
        # cost.  The microbench below times the replicated per-CG-
        # iteration vector ops at this n and predicts the max-device
        # conservation from it; measured ~0.6-0.7 at 8 devices on the
        # session's 2-core host matches the prediction.
        import os as _os

        total_cg = args.outer_iters * (args.cg_iters + 2)
        node_s = _replicated_node_work_s(n, total_cg, jax, np)
        cores = _os.cpu_count() or 1
        D = counts[-1]
        pred = t1_min / (t1_min + (D - 1) * node_s / cores)
        out["replicated_node_cg_s"] = round(node_s, 3)
        out["host_cores"] = cores
        out["wc_predicted_from_replication"] = {str(D): round(pred, 3)}
    return out


def _replicated_node_work_s(n, iters, jax, np):
    """1-device wall time of the replicated (n,3) CG vector ops — the
    work every virtual device duplicates in the sharded solve."""
    import time as _time

    import jax.numpy as jnp

    @jax.jit
    def vec_iters(x, r, p, dinv, k):
        def body(i, st):
            x, r, p = st
            alpha = jnp.sum(p * r) / (jnp.sum(p * p) + 1.0)
            x = x + alpha * p
            r = r - alpha * p
            z = dinv[:, None] * r
            beta = jnp.sum(r * z) / (jnp.sum(p * r) + 1.0)
            return x, r, z + beta * p
        return jax.lax.fori_loop(0, k, body, (x, r, p))

    x = jnp.ones((n, 3), jnp.float32)
    dinv = jnp.ones((n,), jnp.float32)
    jax.block_until_ready(vec_iters(x, x, x, dinv, iters))
    t0 = _time.perf_counter()
    jax.block_until_ready(vec_iters(x, x, x, dinv, iters))
    return _time.perf_counter() - t0


if __name__ == "__main__":
    main()
