"""The traced window of a ``--trace 1`` run: one ``torch.profiler``
session (CPU and CUDA activities), opened after warm-up, read into the
numbers the per-layer readers and the result's ``device`` and
``breakdown`` take.

The session starts with :data:`SPINS` spin kernels and a synchronize (a
session can miss its first events), then the window runs inside a
``portbench.window`` annotation and ends with a synchronize, so every
device operation of the window lies inside it. Device time is the union of
the kernels', copies' and memsets' intervals inside the window (spin
kernels and annotations left out); idle gaps are the window's time outside
that union, each named by the shortest host event (an operation or a
``portbench.*`` span, on any thread) that spans the gap's middle. The
interpreter's collections of generations 1 and 2 are spans of their own
(``portbench.gc1``, ``portbench.gc2``), so a gap the collector holds shows
by that name.
"""

from __future__ import annotations

import collections
import contextlib
import gc
from typing import Any, Dict, List, Optional, Tuple

SPINS = 20
WINDOW = "portbench.window"


def span(name: str):
    """A host span that shows in the trace (a no-op outside a session)."""
    import torch

    return torch.profiler.record_function(f"portbench.{name}")


class Session:
    """``with Session(on) as s:`` around the window; :meth:`read` after."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self._gc_spans = {}

    def _gc(self, phase, info):
        import torch

        gen = info.get("generation", 0)
        if gen < 1:
            return
        if phase == "start":
            span = torch.profiler.record_function(f"portbench.gc{gen}")
            span.__enter__()
            self._gc_spans[gen] = span
        else:
            span = self._gc_spans.pop(gen, None)
            if span is not None:
                span.__exit__(None, None, None)

    def __enter__(self):
        if not self.enabled:
            self._window = contextlib.nullcontext()
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        if self.cuda:
            for _ in range(SPINS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        if self.prof is None:
            return False
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        gc.callbacks.remove(self._gc)
        self._window.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def read(self) -> Optional[Dict[str, Any]]:
        if self.prof is None:
            return None
        return summarize(self.prof.profiler.kineto_results.events())


def _is_device_op(e) -> bool:
    kind = str(e.device_type())
    if not kind.endswith("CUDA"):
        return False
    return not (e.is_user_annotation() or e.name().startswith("portbench."))


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events) -> Dict[str, Any]:
    """busy_s, window_s, kernel seconds by name, breakdown."""
    window = None
    host = []
    device = []
    for e in events:
        name = e.name()
        if not _is_device_op(e):
            if name == WINDOW and not str(e.device_type()).endswith("CUDA"):
                window = (e.start_ns(), e.end_ns())
            elif not str(e.device_type()).endswith("CUDA"):
                host.append((e.start_ns(), e.end_ns(), name))
            continue
        if "spin_kernel" in name:
            continue
        device.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        raise RuntimeError("the trace holds no window annotation")
    w0, w1 = window
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in device
              if b > w0 and a < w1]
    busy = _merge([(a, b) for a, b, _ in inside])
    busy_ns = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = collections.defaultdict(float)
    counts: Dict[str, int] = collections.defaultdict(int)
    for a, b, n in inside:
        by_name[n] += (b - a) * 1e-9
        counts[n] += 1
    gaps = []
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    host = [h for h in host if h[1] > w0 and h[0] < w1]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) // 2
        over = [h for h in host if h[0] <= mid <= h[1]]
        label = min(over, key=lambda h: h[1] - h[0])[2] if over else "none"
        named.append([label, (b - a) * 1e-9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_ns * 1e-9,
        "window_s": (w1 - w0) * 1e-9,
        "kernel_s": dict(by_name),
        "kernel_count": dict(counts),
        "breakdown": {"device_ops": [[n, s] for n, s in top],
                      "idle_gaps": named},
    }
