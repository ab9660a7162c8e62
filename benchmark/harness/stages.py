"""Seconds spent in each stage of set-up, on the host clock."""

from __future__ import annotations

import time
from typing import Dict


class Stages:
    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, stage: str) -> None:
        now = time.perf_counter()
        self.seconds[stage] = now - self._t
        self._t = now
