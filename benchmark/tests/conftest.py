"""Shared helpers of the benchmark's tests: cells cut to a size the CPU
runs in seconds (the program's "pallas" backend runs its plain PyTorch
version on CPU tensors), and the card fixture of the `cuda` tests."""

from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_LOG = {"num_users": 1536, "num_items": 1024, "interactions": 30_000}


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_cell(name: str):
    """The cell `name` on a 1,536 x 1,024 log (3 train steps an epoch),
    requests of 256 users; everything else as the cell has it."""
    from benchmark.harness import cells

    cell = cells.load_cell(name, load_benchmark())
    cell.log = {**cell.log, **TINY_LOG}
    if cell.kind == "refresh":
        cell.traffic = {**cell.traffic, "request_users": 256}
    return cell


@pytest.fixture
def cpu_threads():
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    """The card, or a skip where none is visible (decided here, at run
    time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
