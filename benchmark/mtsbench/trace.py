"""The traced run's device timeline, read from torch.profiler's raw events.

`capture()` wraps the window in `torch.profiler.profile` (CPU and CUDA
activity). `Timeline` turns the raw kineto events into what the per-layer
readers and the result's `breakdown` need: device time by kernel name, the
busy time (the union of device activity intervals, kernels, copies and sets
counted once where they overlap), the idle gaps between them labelled by
what the host was doing (the innermost benchmark span and program op open
on the window's thread when the gap began), and device time attributed to
the program ops that launched it. The raw events are read directly: torch's
FunctionEvent tree takes tens of seconds to build for the recurrent
taggers' launches and nothing here needs it.
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

SPAN_PREFIX = "mtsbench."
WINDOW = "window"  # the span around the whole window, on the window's thread


@contextlib.contextmanager
def capture(enabled: bool):
    """Yields the profiler (or None when not enabled)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def span(name: str, traced: bool):
    """A benchmark span visible in the trace (a user annotation)."""
    if not traced:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


class Timeline:
    """Device and host events of one traced window."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        self.device: List[tuple] = []  # (start, end, name, external id, correlation ids)
        self.host: List[tuple] = []    # (start, end, name, thread, external id, correlation id)
        events = prof.profiler.kineto_results.events()
        # a kernel's linked correlation id is that of the program op that
        # launched it; external ids exist in newer torch releases only
        ext = (lambda e: e.external_id()) if events and hasattr(events[0], "external_id") \
            else (lambda e: 0)
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if name.startswith(SPAN_PREFIX):  # a span's shadow on the device's timeline
                    continue
                self.device.append((start, start + dur, name, ext(e),
                                    (e.correlation_id(), e.linked_correlation_id())))
            else:
                self.host.append((start, start + dur, name, e.start_thread_id(),
                                  ext(e), e.correlation_id()))
        # the window's thread: the one that opened the outermost span
        windows = [h for h in self.host if h[2] == SPAN_PREFIX + WINDOW]
        self.thread_id = windows[0][3] if windows else None
        self._finish()

    @classmethod
    def from_events(cls, device: List[tuple], host: List[tuple], thread_id: int):
        """A timeline of given events (tests)."""
        self = cls.__new__(cls)
        self.device, self.host, self.thread_id = list(device), list(host), thread_id
        self._finish()
        return self

    def _finish(self):
        self.device.sort()
        merged: List[List[int]] = []
        for a, b, *_ in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_intervals = merged
        self.busy_s = sum(b - a for a, b in merged) / 1e9

    def kernel_time(self) -> Dict[str, Tuple[float, int]]:
        """{name: (device seconds, launches)}."""
        out: Dict[str, list] = defaultdict(lambda: [0.0, 0])
        for a, b, name, *_ in self.device:
            out[name][0] += (b - a) / 1e9
            out[name][1] += 1
        return {k: (v[0], v[1]) for k, v in out.items()}

    def matching(self, pred: Callable[[str], bool]) -> Tuple[float, int]:
        """(device seconds, launches) of the device events whose name matches."""
        s, n = 0.0, 0
        for a, b, name, *_ in self.device:
            if pred(name):
                s += (b - a) / 1e9
                n += 1
        return s, n

    def top_ops(self, k: int = 10) -> List[list]:
        ranked = sorted(self.kernel_time().items(), key=lambda kv: -kv[1][0])[:k]
        return [[name, secs] for name, (secs, _) in ranked]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle time between device activity, summed by what the host was doing
        when each gap began: [["<span>: <op>", seconds], ...], the k largest.
        The host's events on the window's thread nest, so one sweep over the
        gaps in time order keeps the open ones on a stack."""
        events = sorted((h for h in self.host if h[3] == self.thread_id),
                        key=lambda h: (h[0], -h[1]))
        stack: List[tuple] = []
        j = 0
        by_label: Dict[str, float] = defaultdict(float)
        for (a0, b0), (a1, _) in zip(self.busy_intervals, self.busy_intervals[1:]):
            if a1 <= b0:
                continue
            while j < len(events) and events[j][0] <= b0:
                while stack and stack[-1][1] <= events[j][0]:
                    stack.pop()
                stack.append(events[j])
                j += 1
            while stack and stack[-1][1] <= b0:
                stack.pop()
            span_name = next((e[2][len(SPAN_PREFIX):] for e in reversed(stack)
                              if e[2].startswith(SPAN_PREFIX)), "outside spans")
            op = next((e[2] for e in reversed(stack) if not e[2].startswith(SPAN_PREFIX)
                       and not e[2].startswith(("cuda", "cu", "Memcpy", "Memset"))), "python")
            by_label[f"{span_name}: {op}"] += (a1 - b0) / 1e9
        return [[k_, v] for k_, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:k]]

    def launched_under(self, pred: Callable[[str], bool]) -> Optional[float]:
        """Device seconds of the kernels launched inside host ops whose name
        matches `pred` (their nested ops included), linked by the ops'
        external ids and the launches' correlation ids; None when no such op
        ran."""
        roots: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        for a, b, name, tid, *_ in self.host:
            if pred(name):
                roots[tid].append((a, b))
        if not roots:
            return None
        for tid in roots:
            roots[tid].sort()
        starts = {tid: [r[0] for r in rs] for tid, rs in roots.items()}

        def inside(t, tid):
            rs = roots.get(tid)
            if not rs:
                return False
            i = bisect.bisect_right(starts[tid], t) - 1
            return i >= 0 and rs[i][0] <= t <= rs[i][1]

        ext, corr = set(), set()
        for a, b, name, tid, ext_id, corr_id in self.host:
            if inside(a, tid):
                if ext_id:
                    ext.add(ext_id)
                if corr_id:
                    corr.add(corr_id)
        total = 0.0
        for a, b, name, ext_id, corr_ids in self.device:
            if (ext_id and ext_id in ext) or any(c and c in corr for c in corr_ids):
                total += (b - a) / 1e9
        return total
