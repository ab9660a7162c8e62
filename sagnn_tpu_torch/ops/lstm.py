"""LSTM over the interval axis with TF1 BasicLSTMCell semantics; the port
of `sagnn_tpu/ops/lstm.py`.

Reference (model.py:135-146): one `BasicLSTMCell(latdim)` in a
`DropoutWrapper(output_keep_prob=keepRate)`, run over the graph_num axis.
The same cell serves users and items (Q4).

    gates = [x, h] @ kernel + bias            kernel: [D+H, 4H]
    i, j, f, o = split(gates, 4)              (input, cell, forget, output)
    c' = c * sigmoid(f + forget_bias) + sigmoid(i) * tanh(j)   forget_bias=1
    h' = sigmoid(o) * tanh(c')

Output dropout (a fresh mask per timestep, scaled by 1/keep) applies only
in training, when a keep mask is given; inference passes none. The caller
draws the mask with `dropout_keep_mask`, on the output's device, from a
generator on that device, outside any region that is recomputed in the
backward (`torch.utils.checkpoint`): the checkpoint restores only the
default generators, so a mask drawn inside from an explicit generator
would differ between the forward and its recompute.

In bf16 (x and the parameters cast by the caller, fusion_dtype="bf16")
the gates, c and h stay bf16, as the JAX scan keeps them: each op rounds
to bf16, with the Python scalars (the forget bias, the 1/keep scale)
rounded to bf16 first, as JAX rounds a weak-typed scalar.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from sagnn_tpu_torch.models.layers import scalar_as


def dropout_keep_mask(gen: torch.Generator, shape, keep_rate: float,
                      device: torch.device | str) -> torch.Tensor:
    """The output dropout's keep mask [N, T, H] (bool), one uniform draw
    per element from `gen`, kept where it is below keep_rate."""
    return torch.rand(shape, generator=gen, device=device) < keep_rate


def lstm_scan(params: Dict[str, torch.Tensor], x: torch.Tensor,
              forget_bias: float = 1.0, keep_rate: float = 1.0,
              keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [N, T, D] -> outputs [N, T, H] (all h_t, like dynamic_rnn).
    With keep_rate < 1 and a `keep_mask` [N, T, H], the outputs are dropped
    where the mask is False and scaled by 1/keep_rate."""
    N, T, D = x.shape
    kernel, bias = params["kernel"], params["bias"]
    H = kernel.shape[1] // 4
    # split concat([x, h]) @ kernel into an x part (one matmul for all
    # timesteps) and an h part per step
    w_x, w_h = kernel[:D], kernel[D:]
    x_gates = (x.reshape(N * T, D) @ w_x + bias).reshape(N, T, 4 * H)
    c = torch.zeros((N, H), dtype=x.dtype, device=x.device)
    h = torch.zeros((N, H), dtype=x.dtype, device=x.device)
    hs = []
    for t in range(T):
        gates = x_gates[:, t] + h @ w_h
        i, j, f, o = torch.split(gates, H, dim=-1)
        c = c * torch.sigmoid(f + scalar_as(forget_bias, x.dtype)) + \
            torch.sigmoid(i) * torch.tanh(j)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    out = torch.stack(hs, dim=1)
    if keep_rate < 1.0 and keep_mask is not None:
        out = torch.where(keep_mask, out / scalar_as(keep_rate, out.dtype),
                          torch.zeros_like(out))
    return out
