"""L2 — rotation-averaging solver (array-native replacement of ral/).

The reference solves robust rotation averaging with SuiteSparse direct
factorizations inside two outer loops (ral/l1_irls.cpp: `l1ra` + `irls`).
Here the same outer iterations run under `jit` with:

  * the view graph as static-shaped arrays (`RotationGraph`);
  * the weighted least-squares step solved either by a dense batched
    Cholesky of the masked graph Laplacian (small/medium n)
    or by matrix-free preconditioned CG whose SpMV is a segment-sum
    (scalable / shardable);
  * all 14 robust IRLS costs as a vectorised switch;
  * the l1-magic primal-dual decoder re-expressed with batched (vmapped)
    SPD solves over the three tangent axes.
"""

from irotavg_tpu.solver.graph import RotationGraph  # noqa: F401
from irotavg_tpu.solver.irls import Cost, irls  # noqa: F401
from irotavg_tpu.solver.l1ra import l1ra  # noqa: F401
from irotavg_tpu.solver.init import init_mst  # noqa: F401
from irotavg_tpu.solver.io import read_problem, write_solution  # noqa: F401
