"""Per-step wall-clock timer; the port of `StepTimer` from
`sagnn_tpu/utils/profiling.py`. Time on the card only means something
when the timed span ends in a synchronisation (the trainer's spans end in
a fetch of the previous step's losses). `cuda_ms` times device work with
CUDA events."""

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
