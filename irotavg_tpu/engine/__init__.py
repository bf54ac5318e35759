"""L4 — view-graph engine: incremental windowed rotation averaging.

Array-native re-design of the solver bridge in `src/ViewGraph.cpp:1263-1435`:
the view graph lives as growing host arrays; each `rot_avg(win_size)` call
gathers the window subproblem, reindexes fixed rotations to a leading
prefix, pads to a size bucket, and runs the jitted L1-RA + IRLS pipeline on
device with a warm start (the reference also warm-starts — its init_mst
call is commented out, src/ViewGraph.cpp:1396-1397).
"""

from irotavg_tpu.engine.incremental import IncrementalRotAvg  # noqa: F401
