"""Distributed rotation averaging over a `jax.sharding.Mesh`.

No reference equivalent — the C++ system is single-threaded (SURVEY.md §2).
The scaling axis here is *graph parallelism*: edges of the view graph are
sharded across devices; absolute rotations (nodes) are replicated.  Each
device computes residuals / Laplacian partials on its edge block and the
normal-equation reduction is a single `psum` over the mesh axis — the
array-native analogue of a distributed PCG.
"""

from irotavg_tpu.parallel.sharded import (  # noqa: F401
    GRAPH_AXIS,
    init_multihost,
    make_graph_mesh,
    shard_graph,
    sharded_irls,
    sharded_irls_step,
    sharded_ravg_pipeline,
)
