"""Ranking metrics HR@K / NDCG@K and the per-epoch metric history; the port
of the candidate-protocol part of `sagnn_tpu/train/metrics.py` (ref:
model.py:484-510 `calcRes`, model.py:24-39).

The reference sorts (score, item) pairs per user with Python's STABLE
descending sort. The positive candidate is appended LAST (model.py:404),
so every candidate with a greater OR EQUAL score ranks ahead of it:

    rank(pos) = #{j < C-1 : s_j >= s_pos}
    hit@K  = rank < K
    ndcg@K = 1/log2(rank+2) if hit else 0
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import torch


def positive_ranks(scores: torch.Tensor) -> torch.Tensor:
    """scores: [B, C] with the positive at column C-1 -> int32 ranks [B]."""
    pos = scores[:, -1:]
    others = scores[:, :-1]
    return torch.sum(others >= pos, dim=1).to(torch.int32)


def metrics_from_ranks(ranks: torch.Tensor,
                       valid: torch.Tensor | None = None,
                       ks=(1, 5, 10, 15, 20)) -> Dict[str, torch.Tensor]:
    """Summed HR/NDCG per K over the batch from positive ranks [B] (the
    caller divides by the user count, as the reference does,
    model.py:466-479)."""
    ndcg_all = 1.0 / torch.log2(ranks.float() + 2.0)
    v = valid if valid is not None else torch.ones_like(ndcg_all)
    out = {}
    for k in ks:
        hit = (ranks < k).float() * v
        out[f"HR@{k}"] = torch.sum(hit)
        out[f"NDCG@{k}"] = torch.sum(ndcg_all * hit)
    return out


def topk_metrics(scores: torch.Tensor, ks=(1, 5, 10, 15, 20),
                 valid: torch.Tensor | None = None
                 ) -> Dict[str, torch.Tensor]:
    """Summed HR/NDCG per K of candidate scores [B, C] (positive last)."""
    return metrics_from_ranks(positive_ranks(scores), valid=valid, ks=ks)


@dataclass
class MetricsHistory:
    """Per-epoch metric lists (ref: model.py:24-28 self.metrics)."""

    data: Dict[str, List[float]] = field(default_factory=lambda: {
        f"{phase}{met}": []
        for phase in ("Train", "Test")
        for met in ("Loss", "preLoss", "HR", "NDCG")
    })

    def append(self, phase: str, values: Dict[str, float]) -> None:
        for met, val in values.items():
            key = phase + met
            if key in self.data:
                self.data[key].append(float(val))

    def format_line(self, name: str, ep: int, total_ep: int,
                    values: Dict[str, float]) -> str:
        """ref makePrint (model.py:30-39)."""
        ret = f"Epoch {ep}/{total_ep}, {name}: "
        ret += ", ".join(f"{m} = {v:.4f}" for m, v in values.items())
        return ret + "  "

    @property
    def num_tests(self) -> int:
        return len(self.data["TestHR"])
