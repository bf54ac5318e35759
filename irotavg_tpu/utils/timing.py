"""Per-stage timing and profiling.

The reference's observability is `clock()` brackets printing per-frame
``frame creation / frame processing / rotavg`` seconds
(src/IRotAvg.cpp:258,273-274,356-357,379-383) and solver runtime
out-params (ral/l1_irls.cpp:581-583,741-743).  This module keeps that
per-frame timing line as a compatible observable and adds structured
aggregation plus an optional `jax.profiler` trace context for device-level
profiling.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class StageTimer:
    """Accumulating wall-clock timer keyed by stage name."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.last: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.last[name] = dt

    def frame_line(self, frame_id: int) -> str:
        """The reference's per-frame printf (src/IRotAvg.cpp:382-383)."""
        return (
            f"frame {frame_id}  -- runtimes: "
            f"frame creation {self.last.get('frame_creation', 0.0):.3f}; "
            f"frame processing {self.last.get('frame_processing', 0.0):.3f}, "
            f"rotavg {self.last.get('rotavg', 0.0):.3f}"
        )

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(1, self.counts[name]),
            }
            for name in self.totals
        }


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """`jax.profiler.trace` context when ``log_dir`` is set; no-op else."""
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
