"""Profiling: accumulating host stage timers (`StageTimer`, which keeps
SlamEngine.timings) and a torch.profiler trace (the port of the JAX
package's utils/profiling.py, whose `xla_trace` becomes `torch_trace`).

    with torch_trace("LOGDIR") as prof:    # LOGDIR/trace.json, Chrome format
        engine.run()
    prof.key_averages()                     # the profile, when wanted

`torch_trace(None)` does nothing and yields None.  The trace holds the
host's operators and, on a GPU, the device's kernels (CUPTI)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class StageTimer:
    """Accumulating wall-clock timers keyed by stage name.  A stage timed
    inside another counts only to itself: the outer stage's total leaves
    it out (the panels drawn inside a mapping event count under 'vis',
    not 'map')."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        # [start, seconds of the stages nested in it] of each open stage
        self._open: list = []

    @contextlib.contextmanager
    def time(self, name: str):
        frame = [time.perf_counter(), 0.0]
        self._open.append(frame)
        try:
            yield
        finally:
            self._open.pop()
            dt = time.perf_counter() - frame[0]
            self.totals[name] += dt - frame[1]
            self.counts[name] += 1
            if self._open:
                self._open[-1][1] += dt

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:>16}: {t:8.3f}s total, {c:6d} calls, "
                         f"{1000 * t / max(c, 1):8.2f} ms/call")
        return "\n".join(lines)


@contextlib.contextmanager
def torch_trace(logdir: Optional[str]):
    """Profile the block with torch.profiler (host operators, and the
    device's kernels when CUDA is available) and write the Chrome trace
    to logdir/trace.json.  Yields the profiler; a no-op when logdir is
    None."""
    if logdir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
