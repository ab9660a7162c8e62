"""TF1-exact Adam with staircase exponential decay; the port of
`scale_by_tf1_adam` and `make_optimizer` in `sagnn_tpu/train/trainer.py`
(ref model.py:248-250; TF1 AdamOptimizer defaults b1 0.9, b2 0.999,
eps 1e-8).

TF1 computes, per step t (counted from 1):

    m = b1·m + (1-b1)·g
    v = b2·v + (1-b2)·g²
    update = lr_t · sqrt(1-b2^t)/(1-b1^t) · m / (sqrt(v) + eps)

The bias corrections fold into the step size and eps sits on the
UNCORRECTED sqrt(v), so TF's effective epsilon is eps/sqrt(1-b2^t), ~30×
that of `torch.optim.Adam` at step 1: that optimizer is not this one.
lr_t = lr · decay^floor(count / decay_step) reads the count BEFORE this
step's increment, as tf.train.exponential_decay under
minimize(global_step=...). Both scalars are computed in float32, as the
JAX package computes them on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

Params = Dict[str, torch.Tensor]


@dataclass
class AdamState:
    """Adam's moments in the params' flat layout, and the step count."""

    mu: Params
    nu: Params
    count: int = 0


class TF1Adam:
    def __init__(self, lr: float, decay: float, decay_step: int,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr = lr
        self.decay = decay
        self.decay_step = max(1, decay_step)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Params) -> AdamState:
        return AdamState(
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()})

    def learning_rate(self, count: int) -> float:
        """The staircase rate for a step taken at pre-increment `count`."""
        f32 = torch.float32
        p = torch.floor(torch.tensor(count, dtype=f32)
                        / torch.tensor(self.decay_step, dtype=f32))
        return float(torch.tensor(self.lr, dtype=f32)
                     * torch.tensor(self.decay, dtype=f32) ** p)

    def step_size(self, count: int) -> float:
        """lr_t · sqrt(1-b2^t)/(1-b1^t) for the step taken at `count`."""
        t = torch.tensor(count + 1, dtype=torch.float32)
        corr = torch.sqrt(1.0 - self.b2 ** t) / (1.0 - self.b1 ** t)
        return float(torch.tensor(self.learning_rate(count)) * corr)

    @torch.no_grad()
    def step(self, params: Params, grads: Params, state: AdamState) -> None:
        """One update of `params` and `state`, in place (the JAX package
        builds new arrays; updating in place keeps one copy of each)."""
        keys = list(params)
        p: List[torch.Tensor] = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        m = [state.mu[k] for k in keys]
        v = [state.nu[k] for k in keys]
        size = self.step_size(state.count)
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - self.b1))
        torch._foreach_mul_(v, self.b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(g, 1 - self.b2), g))
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_add_(p, torch._foreach_div(m, denom), alpha=-size)
        state.count += 1
