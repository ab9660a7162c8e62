"""The numbers that decide `correct`, each held to its limit.

Training, with the reference stepping from the program's own state before
each checked step (harness/train.py): each step's loss; per leaf, the norm
of the first gradient as the optimizer got it, and the norm of each step's
change of the parameters, each as the gap between the program's norm and
the reference's over the larger of the reference's norm of that leaf and
of the median leaf. The gradient and the changes are taken at the median
leaf; the gradient also at the worse of the two tables that propagation
reads and writes (`reg/u_embed`, `reg/i_embed`: the segment-sum kernel's
backward writes only their gradients, which the median never sees). Leaves
whose reference gradient in that step is under a thousandth of the median
leaf's are left out (they move under Adam by round-off alone).

Serving: the served scores against the reference's scores of the same
items, and how far each served item lies below the reference's item of the
same rank, both over the user's score spread.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

ZERO_GRAD_SHARE = 1e-3
# the tables propagation reads and writes
TABLES = ("reg/u_embed", "reg/i_embed")


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's 2-norm, summed in f64."""
    keys = sorted(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[k].detach(),
                                                 dtype=torch.float64)
                        for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def moved_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    med = float(np.median(list(ref_grad.values())))
    return sorted(k for k, v in ref_grad.items() if v >= ZERO_GRAD_SHARE * med)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    """Per leaf |prog - ref| / max(ref, the median leaf's ref)."""
    med = float(np.median([ref[k] for k in leaves]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog: {"losses": [..], "grad": {leaf: norm}, "change": [{..}, ..]}
    per checked step; ref: the same from `reference_steps`, with "grads",
    each step's gradient norms."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"])]
    first = leaf_gaps(prog["grad"], ref["grad"], moved_leaves(ref["grad"]))
    change = [float(np.median(list(leaf_gaps(p, r, moved_leaves(g))
                                   .values())))
              for p, r, g in zip(prog["change"], ref["change"],
                                 ref["grads"])]
    if len(prog["losses"]) != len(ref["losses"]) or \
            len(prog["change"]) != len(ref["change"]):
        losses.append(math.inf)       # a step the program did not take
        change.append(math.inf)
    return {"loss_gap": max(losses),
            "grad_med_gap": float(np.median(list(first.values()))),
            "grad_embed_gap": max(first.get(k, 0.0) for k in TABLES),
            "change_med_gap": max(change)}


def serve_numbers(served_scores: torch.Tensor, served_ids: torch.Tensor,
                  ref_scores: torch.Tensor) -> Dict[str, float]:
    """served_*: [B, k] as the program returned them; ref_scores: [B, I]
    the reference's scores with the seen items at -inf."""
    k = served_ids.shape[1]
    finite = torch.isfinite(ref_scores)
    n = finite.sum(1, keepdim=True).double()
    x = torch.where(finite, ref_scores.double(), torch.zeros_like(
        ref_scores, dtype=torch.float64))
    mean = x.sum(1, keepdim=True) / n
    var = (torch.where(finite, x - mean, torch.zeros_like(x)) ** 2).sum(
        1, keepdim=True) / n
    spread = var.sqrt()
    best = torch.topk(ref_scores, k, dim=1).values.double()
    at_served = ref_scores.gather(1, served_ids.long()).double()
    rank = ((best - at_served) / spread).max().item()
    score = ((served_scores.double() - at_served).abs() / spread).max().item()
    return {"score_gap": score if math.isfinite(score) else math.inf,
            "rank_gap": rank if math.isfinite(rank) else math.inf}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{"correct": bool, "check": {name: {"value", "limit"}}}: correct
    when every number has a limit and is within it."""
    check = {k: {"value": v, "limit": limits.get(k)}
             for k, v in numbers.items()}
    ok = bool(numbers) and all(
        c["limit"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in check.values())
    return {"correct": ok, "check": check}
