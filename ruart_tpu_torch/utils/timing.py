"""Named wall-clock timers (reference `Utils/Timing.py`), plus a context
manager and a torch.profiler trace hook — port of
``ruart_tpu/utils/timing.py``."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class Timers:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._starts: Dict[str, float] = {}

    def start(self, name: str):
        self._starts[name] = time.perf_counter()

    def stop(self, name: str):
        if name in self._starts:
            self.totals[name] += time.perf_counter() - self._starts.pop(name)
            self.counts[name] += 1

    @contextlib.contextmanager
    def timer(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(
                f"{name}: total {tot:.3f}s, count {n}, avg {tot / max(n, 1) * 1e3:.2f}ms"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """Wrap a region in a ``torch.profiler`` trace written to ``logdir``
    (a chrome-trace ``*.pt.trace.json``, which TensorBoard's profiler
    plugin reads) when ``logdir`` is set; the CUDA activity is traced when
    a card is present. Does nothing when ``logdir`` is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
