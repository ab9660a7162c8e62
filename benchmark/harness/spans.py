"""The program's own spans in a traced window, and the device's time
charged to them.

The program names its work with `sagnn.<layer>.<what>` spans
(`sagnn_tpu_torch.utils.profiling.span`: a `record_function` while the
profiler records), CPU events in the same kineto trace as the kernels. Each
device event (kernel or copy) is charged to one span:

- A kernel is linked by the profiler to the CPU op that launched it (its
  `linked_correlation_id` is that op's `correlation_id`), and that op
  carries the launching thread and a time inside the launch.
- Launched inside an `autograd::engine::evaluate_function: <Node>` event
  (the backward), it is charged through that event's `sequence_nr` and
  `fwd_thread_id` to the forward op that made the node: to the innermost
  span around that op. Where no forward op is found, it falls to the main
  thread's innermost span at the launch (`sagnn.train.backward`, which
  waits in `torch.autograd.grad` meanwhile).
- Otherwise it is charged to the innermost span around the launch on the
  launching thread.
- Everything else (no linked op, or no span around it: the harness's own
  copies, the sampler thread's batch copies, since the profiler records no
  spans on a worker thread) goes to `NO_SPAN`.

A span is known by its path, the names from the outermost span down; a
metric reads a name's subtree, every path that holds the name. The main
thread (the harness's `bench.window` span's) gives each span name's own
wall time.

`run.py` hands the readers the trace's summary and not its events. The
events are taken from the run's `Tracer`, which the readers' caller holds
(`from_context`); a context that carries "spans" already is read as it is.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from benchmark.harness.trace import WINDOW_SPAN

PREFIX = "sagnn."
NO_SPAN = "no span"
# the CUDA runtime's and driver's calls (cudaLaunchKernel, cuLaunchKernel,
# ...): CPU events of the trace whose correlation ids are CUPTI's, another
# numbering than the ops' that kernels link to
RUNTIME = "cu"
BACKWARD = "autograd::engine::evaluate_function: "
SEP = "/"


@dataclass
class SpanSummary:
    # span path ("a/b/c", or NO_SPAN) -> device seconds charged to it
    device_s: Dict[str, float] = field(default_factory=dict)
    # span name -> (summed wall seconds, occurrences) on the main thread
    host: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    # device op name -> seconds, of the events charged to no span
    unspanned: Dict[str, float] = field(default_factory=dict)

    def seen(self, name: str) -> bool:
        return name in self.host or any(
            name in p.split(SEP) for p in self.device_s)

    def subtree_s(self, name: str) -> Optional[float]:
        """Device seconds charged to `name` or to any span inside it;
        None where the trace holds no such span."""
        if not self.seen(name):
            return None
        return sum(s for p, s in self.device_s.items()
                   if name in p.split(SEP))

    def host_s(self, name: str) -> Optional[float]:
        """The span's summed wall seconds on the main thread; None where
        the trace holds no such span."""
        got = self.host.get(name)
        return None if got is None else got[0]


class _Steps:
    """Nested intervals on one thread as a step function: the innermost
    interval's payload at any time (an interval that outlasts the one
    around it is cut at its end)."""

    def __init__(self, intervals: List[Tuple[int, int, object]]):
        self.at: List[int] = []
        self.what: List[object] = []
        stack: List[Tuple[int, object]] = []
        for s, e, what in sorted(intervals, key=lambda x: (x[0], -x[1])):
            while stack and stack[-1][0] <= s:
                self._pop(stack)
            if stack:
                e = min(e, stack[-1][0])
            stack.append((e, what))
            self._put(s, what)
        while stack:
            self._pop(stack)

    def _put(self, t: int, what) -> None:
        if self.at and self.at[-1] == t:
            self.what[-1] = what
        else:
            self.at.append(t)
            self.what.append(what)

    def _pop(self, stack) -> None:
        end, _ = stack.pop()
        self._put(end, stack[-1][1] if stack else None)

    def find(self, t: int):
        i = bisect.bisect_right(self.at, t) - 1
        return self.what[i] if i >= 0 else None


def _paths(spans: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str]]:
    """The spans of one thread with each name replaced by its path."""
    out, stack = [], []
    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            stack.pop()
        path = (stack[-1][1] + SEP + n) if stack else n
        stack.append((e, path))
        out.append((s, e, path))
    return out


def reduce_spans(events) -> SpanSummary:
    """SpanSummary of kineto events (those of `Tracer.summary`). The main
    thread is the `bench.window` span's, else the thread with the most
    spans. A trace holds millions of events, and a
    method call on one costs about a microsecond: an event is asked only
    what its kind needs."""
    from torch.autograd import DeviceType

    from benchmark.harness.trace import _annotation

    device: List[tuple] = []      # (linked op's correlation id, ns, event)
    spans: Dict[int, list] = defaultdict(list)
    ops = []
    main_thread = None
    on_card, on_host = DeviceType.CUDA, DeviceType.CPU
    for e in events:
        kind = e.device_type()
        if kind == on_card:
            if not _annotation(e):
                device.append((e.linked_correlation_id(), e.duration_ns(),
                               e))
        elif kind == on_host:
            if not e.is_user_annotation():
                ops.append(e)
                continue
            name = e.name()
            if name.startswith(PREFIX):
                s = e.start_ns()
                spans[e.start_thread_id()].append(
                    (s, s + e.duration_ns(), name))
            elif name == WINDOW_SPAN:
                main_thread = e.start_thread_id()
    out = SpanSummary()
    if not spans:                   # a program without spans
        return out
    linked = {link for link, _, _ in device if link > 0}
    backward: Dict[int, list] = defaultdict(list)
    launches: Dict[int, Tuple[int, int]] = {}     # correlation id -> launch
    fwd: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for e in ops:
        name = e.name()
        if name.startswith(RUNTIME):
            continue
        node = name.startswith(BACKWARD)
        seq = e.sequence_nr()
        corr = e.correlation_id()
        if not (node or seq >= 0 or corr in linked):
            continue
        s, tid = e.start_ns(), e.start_thread_id()
        if node:
            backward[tid].append((s, s + e.duration_ns(),
                                  (seq, e.fwd_thread_id(), s)))
        elif seq >= 0:
            fwd[(tid, seq)].append(s)
        if corr in linked:
            launches[corr] = (tid, s)
    if main_thread is None or main_thread not in spans:
        main_thread = max(spans, key=lambda t: len(spans[t]))
    for s, e, n in spans[main_thread]:
        secs, count = out.host.get(n, (0.0, 0))
        out.host[n] = (secs + (e - s) / 1e9, count + 1)
    inner = {t: _Steps(_paths(v)) for t, v in spans.items()}
    in_backward = {t: _Steps(v) for t, v in backward.items()}
    for starts in fwd.values():
        starts.sort()
    main = inner[main_thread]

    def span_at(tid: int, t: int) -> Optional[str]:
        steps = inner.get(tid)
        return steps.find(t) if steps is not None else None

    charged: Dict[str, float] = defaultdict(float)
    unspanned: Dict[str, float] = defaultdict(float)
    for link, ns, e in device:
        where = launches.get(link)
        path = None
        if where is not None:
            tid, t = where
            node = in_backward[tid].find(t) if tid in in_backward else None
            if node is not None:
                seq, ftid, b0 = node
                starts = fwd.get((ftid, seq)) if seq >= 0 else None
                i = bisect.bisect_left(starts, b0) - 1 if starts else -1
                path = (span_at(ftid, starts[i]) if i >= 0
                        else main.find(t))
            else:
                path = span_at(tid, t)
        if path is None:
            unspanned[e.name()] += ns / 1e9
            path = NO_SPAN
        charged[path] += ns / 1e9
    out.device_s = dict(charged)
    out.unspanned = dict(unspanned)
    return out


def _tracer_events(depth: int = 8):
    """The kineto events of the run's `Tracer`, from the caller's frames
    (None where no traced Tracer is found)."""
    from benchmark.harness.trace import Tracer

    frame = sys._getframe(1)
    for _ in range(depth):
        if frame is None:
            return None
        for v in frame.f_locals.values():
            if isinstance(v, Tracer) and v.prof is not None:
                return v.prof.profiler.kineto_results.events()
        frame = frame.f_back
    return None


def from_context(ctx) -> Optional[SpanSummary]:
    """The run's SpanSummary, reduced once and kept in `ctx`; None where
    the run was not traced on a card."""
    if ctx.get("trace") is None:
        return None
    if "spans" not in ctx:
        events = _tracer_events()
        ctx["spans"] = None if events is None else reduce_spans(events)
    return ctx["spans"]


def reading(ctx, kind: str, name: str, device: bool) -> Optional[float]:
    """ms of span `name` per step (kind "train") or per request (kind
    "refresh") of the traced window: the device time charged to its
    subtree (device), else its wall time on the main thread; None in a
    cell of another kind, or where the trace holds no such span."""
    units = "steps" if kind == "train" else "requests"
    if ctx.get("kind") != kind or not ctx.get(units):
        return None
    summary = from_context(ctx)
    if summary is None:
        return None
    secs = summary.subtree_s(name) if device else summary.host_s(name)
    return None if secs is None else 1e3 * secs / ctx[units]
