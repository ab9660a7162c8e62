"""Ranking metrics HR@K / NDCG@K and the per-epoch metric history; the port
of `sagnn_tpu/train/metrics.py` (ref: model.py:484-510 `calcRes`,
model.py:24-39), the candidate protocol and full-sort evaluation (dense
and streamed over catalog chunks).

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

from sagnn_tpu_torch.ops.chunking import scatter_local_mask


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


def full_sort_ranks(scores: torch.Tensor,
                    pos_items: torch.Tensor) -> torch.Tensor:
    """int32 ranks [B] of each row's positive among scores [B, num_items]
    (excluded items already -inf): the count of other items with a score
    >= the positive's, the candidate protocol's tie rule."""
    s_pos = scores.gather(1, pos_items.long()[:, None])
    # >= counts the positive itself once
    return (torch.sum(scores >= s_pos, dim=1) - 1).to(torch.int32)


def full_sort_metrics(scores: torch.Tensor, pos_items: torch.Tensor,
                      valid: torch.Tensor | None = None,
                      ks=(1, 5, 10, 15, 20)) -> Dict[str, torch.Tensor]:
    """Summed HR/NDCG per K for full-catalog ranking (JAX
    `full_sort_metrics`, metrics.py:65-79): scores [B, num_items] with the
    excluded items set to -inf, pos_items [B]."""
    return metrics_from_ranks(full_sort_ranks(scores, pos_items),
                              valid=valid, ks=ks)


def dense_positive_ranks(queries: torch.Tensor, item_table: torch.Tensor,
                         pos_items: torch.Tensor,
                         excl_idx: torch.Tensor) -> torch.Tensor:
    """Full-catalog positive ranks [B] from dense scores queries @
    item_table^T [B, I] with each row's excluded items (excl_idx [B, K],
    pad I) set to -inf (JAX trainer.py:604-612): the pad id lands in one
    extra column, dropped after the scatter, as JAX's mode="drop" drops
    it."""
    num_items = item_table.shape[0]
    scores = torch.nn.functional.pad(queries @ item_table.T, (0, 1))
    scores.scatter_(1, excl_idx.long(), float("-inf"))
    return full_sort_ranks(scores[:, :num_items], pos_items)


def streaming_positive_ranks(queries: torch.Tensor, item_table: torch.Tensor,
                             pos_items: torch.Tensor, excl_idx: torch.Tensor,
                             num_items: int,
                             chunk_items: int = 65_536) -> torch.Tensor:
    """Full-catalog positive ranks [B] without a [B, num_items] score
    matrix (JAX `streaming_positive_ranks`, metrics.py:82-146):
    rank = #{items j not excluded, j != pos : s_j >= s_pos}, counted over
    catalog chunks of `chunk_items` rows, at most [B, chunk_items] scores
    at a time.

    queries [B, D] (SelfGNN.serving_queries), item_table [I, D],
    pos_items [B], excl_idx [B, K] (pad num_items; never the positive).

    Tie-exact against the dense rank: s_pos is taken from the same chunk
    products the counts compare against (a first pass picks the positive's
    own element), since a separately computed dot can differ by an ulp and
    flip a >= tie. The table is padded to whole chunks so every product
    has one shape. Exclusions mask columns by id, as the dense path's -inf
    does."""
    B = queries.shape[0]
    n_chunks = -(-item_table.shape[0] // chunk_items)
    pad = n_chunks * chunk_items - item_table.shape[0]
    table = torch.nn.functional.pad(item_table, (0, 0, 0, pad))
    chunks = [table[c * chunk_items:(c + 1) * chunk_items]
              for c in range(n_chunks)]
    pos = pos_items.long()
    # pass 1: the positive's score from the chunk that holds it
    s_pos = torch.full((B,), float("-inf"), dtype=queries.dtype,
                       device=queries.device)
    for c, chunk in enumerate(chunks):
        s = queries @ chunk.T
        loc = pos - c * chunk_items
        here = (loc >= 0) & (loc < chunk_items)
        val = s.gather(1, loc.clamp(0, chunk_items - 1)[:, None])[:, 0]
        s_pos = torch.where(here, val, s_pos)
    total = torch.zeros(B, dtype=torch.int32, device=queries.device)
    for c, chunk in enumerate(chunks):
        s = queries @ chunk.T
        gids = c * chunk_items + torch.arange(chunk_items,
                                              device=queries.device)
        keep = (gids[None, :] < num_items) & (gids[None, :] != pos[:, None])
        excluded = scatter_local_mask(excl_idx, c * chunk_items, chunk_items)
        total += torch.sum((s >= s_pos[:, None]) & keep & ~excluded,
                           dim=1).to(torch.int32)
    return total


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
