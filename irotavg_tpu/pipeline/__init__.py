"""Batched-frame (offline) pipeline — the throughput mode.

The reference is strictly incremental: one frame per loop iteration,
every stage a separate call (src/IRotAvg.cpp:251-392).  This package
re-expresses the same computation as large batched device programs —
extraction over frame batches, two-view estimation over pair batches,
one global robust solve — which is where an accelerator's throughput lives.
"""

from irotavg_tpu.pipeline.offline import OfflineResult, run_offline  # noqa: F401
