"""The profiler over a traced window and its reduction: the device's busy
time (the union of its kernels' and copies' intervals), each device
operation's summed time, and the idle gaps labelled by what the host's
main thread was doing (its innermost profiled op at the gap's middle)."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.window"


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    # device op name -> (summed seconds, launches)
    by_name: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    idle_by_label: Dict[str, float] = field(default_factory=dict)

    @property
    def kernel_s(self) -> float:
        return sum(s for s, _ in self.by_name.values())

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.idle_by_label.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, (s, _) in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


class Tracer:
    """torch.profiler (CPU and CUDA activities) while `on`; a no-op
    otherwise."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def summary(self, window_s: float) -> Optional[TraceSummary]:
        if self.prof is None:
            return None
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             window_s)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce_events(events, window_s: float) -> TraceSummary:
    """TraceSummary of kineto events: device events are those whose device
    type is CUDA; the window's bounds and the main thread come from the
    harness's `bench.window` span."""
    from torch.autograd import DeviceType

    device, cpu = [], []
    window = None
    for e in events:
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # a CPU span's mirror on the device timeline is no device work
            if not _annotation(e):
                device.append((e.name(), s, end))
        elif e.device_type() == DeviceType.CPU:
            if e.name() == WINDOW_SPAN:
                window = (s, end, e.start_thread_id())
            cpu.append((s, end, e.start_thread_id(), e.name()))
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for name, s, end in device:
        rec = by_name[name]
        rec[0] += (end - s) / 1e9
        rec[1] += 1
    busy = _union([(s, e) for _, s, e in device])
    busy_s = sum(e - s for s, e in busy) / 1e9
    idle: Dict[str, float] = defaultdict(float)
    if window is not None:
        w0, w1, main = window
        gaps, at = [], w0
        for s, e in busy:
            if s > at:
                gaps.append((at, min(s, w1)))
            at = max(at, e)
        if at < w1:
            gaps.append((at, w1))
        ops = sorted((s, e, n) for s, e, t, n in cpu
                     if t == main and n != WINDOW_SPAN)
        for label, dur in _label_gaps(gaps, ops):
            idle[label] += dur / 1e9
    return TraceSummary(busy_s=busy_s, window_s=window_s,
                        by_name={k: (v[0], int(v[1]))
                                 for k, v in by_name.items()},
                        idle_by_label=dict(idle))


def _annotation(e) -> bool:
    """Whether a device-side event is a user annotation (a
    `record_function` span shown on the device's timeline)."""
    probe = getattr(e, "is_user_annotation", None)
    return e.name() == WINDOW_SPAN or (probe is not None and bool(probe()))


def _label_gaps(gaps, ops):
    """(label, length) of each gap: the innermost op running at its middle
    on the main thread, or "host: no profiled op"."""
    starts = [s for s, _, _ in ops]
    stack: List[Tuple[int, int, str]] = []
    nxt = 0
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        hi = bisect.bisect_right(starts, mid)
        while nxt < hi:
            s, e, n = ops[nxt]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, e, n))
            nxt += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        yield (stack[-1][2] if stack else "host: no profiled op"), g1 - g0
