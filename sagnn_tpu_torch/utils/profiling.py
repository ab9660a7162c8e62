"""Per-step wall-clock timer; the port of `StepTimer` from
`sagnn_tpu/utils/profiling.py`. Time on the card only means something
when the timed span ends in a synchronisation (the trainer's spans end in
a fetch of the previous step's losses). `cuda_ms` times device work with
CUDA events as called; `device_ms` with CUDA events too, with the host's
cost of making the calls taken out."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List


@dataclass
class StepTimer:
    """Accumulates per-step wall times; call .tic() / .toc() around steps."""

    times: List[float] = field(default_factory=list)
    _t0: float = 0.0

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(1, len(self.times))

    def windowed(self, window: int = 0) -> "StepTimer":
        """View over the last `window` samples (0 = all) for mean/percentile."""
        return StepTimer(times=self.times[-window:] if window else self.times)

    def percentile(self, p: float) -> float:
        if not self.times:
            return 0.0
        s = sorted(self.times)
        k = min(len(s) - 1, int(round(p / 100.0 * (len(s) - 1))))
        return s[k]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls on the
    current CUDA stream, after `warmup` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls: CUDA
    events, as `cuda_ms`, but the calls are queued behind a wait on the
    card (twice the time the host took to issue them once) so that the
    card runs them one after another without waiting on the host. The
    host's cost of making the calls, tens of microseconds for a launch
    from Python, then drops out of the time of a short kernel. Where the
    card got past the wait before the host had issued every call, the
    time is taken again behind a wait twice as long; a fn that waits on
    the card itself is timed as called."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    wait_s = 2 * (time.perf_counter() - t0) + 2e-4
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(2):
        # clock cycles at 2 GHz, at least the card's clock, so the wait is
        # no shorter than asked
        torch.cuda._sleep(int(min(wait_s, 2.0) * 2e9))
        start.record()
        for _ in range(iters):
            fn()
        queued = not start.query()
        end.record()
        torch.cuda.synchronize()
        if queued:
            break
        wait_s *= 2
    return start.elapsed_time(end) / iters
