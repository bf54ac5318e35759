"""irotavg_tpu — an accelerator-native rotation-averaging SLAM framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of iRotAvg
(Parra, Chin, Eriksson, Reid — "Visual SLAM: Why bundle adjust?", ICRA 2019):
incremental robust rotation averaging over a view graph built from ORB feature
matches, with DBoW2-style place recognition for loop closure.

Design stance (vs. the C++ reference at ajparra/iRotAvg):
  * array-native: the view graph is a struct-of-arrays (padded edge lists,
    quaternion tables, weight vectors), not pointer-chased objects;
  * batched: frames, descriptors, matches, and RANSAC hypotheses carry a
    leading batch axis and are processed as dense array programs;
  * compiled: every hot loop is `jit`-compatible (static shapes, lax control
    flow) and the inner linear algebra runs as dense batched Cholesky or as
    a matrix-free preconditioned CG whose SpMV is a segment-sum;
  * distributed: large graphs shard over a `jax.sharding.Mesh` with `psum`
    reductions inside `shard_map` (no reference equivalent — the C++ code is
    single-threaded).

Layer map (mirrors SURVEY.md):
  so3          L2 core: quaternion algebra, exp/log maps (ral/l1_irls.cpp:471-532)
  solver/      L2: L1-RA + IRLS rotation averaging           (ral/l1_irls.cpp)
  ops/         L3a compute kernels: FAST, BRIEF, Hamming, pyramid (Pallas/JAX)
  frontend/    L3a: ORB extractor, Frame, Camera             (src/ORBExtractor.cpp, src/Frame.cpp)
  matching/    L4 primitives: BoW/epipolar/local matchers    (src/ViewGraph.cpp:125-569)
  geometry/    L4: batched essential-matrix RANSAC           (src/ViewGraph.cpp:600-691)
  placerec/    L3b: vocabulary tree, BoW scoring, inverted file (third_party/DBoW2)
  engine/      L4: view-graph engine, incremental rotAvg     (src/ViewGraph.cpp)
  parallel/    distributed solver (mesh, shard_map PCG)      (no reference equivalent)
  app/         L5: CLIs, sequence loader, config, outputs    (src/IRotAvg.cpp, ral/test.cpp)
"""

__version__ = "0.1.0"

from irotavg_tpu import so3  # noqa: F401
