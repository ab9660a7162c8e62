"""Multi-head self-attention with the reference's exp-score normalisation,
and TF's layer norm; the port of `sagnn_tpu/ops/attention.py`.

Reference semantics (Utils/attention.py:31-78):
    W_Q/W_K/W_V: dense layers WITH bias (tf.layers.dense default)
    scores = exp(Q Kᵀ / sqrt(d_k))              — raw exp, NOT max-subtracted
    attn   = scores / (sum(scores, -1) + 1e-8)   — Q5
    out    = attn V, heads re-merged; no output projection, no residual.

Raw exp overflows for large logits, so the parity path runs in float32.
`stable=True` switches to the max-subtracted softmax. Parameters are dicts
with the JAX package's leaf names (wq, bq, wk, bk, wv, bv / scale, shift).
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def multi_head_self_attention(params: Dict[str, torch.Tensor],
                              x: torch.Tensor, num_heads: int,
                              stable: bool = False,
                              mask: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """x: [B, T, D] -> [B, T, D] (ref MultiHeadSelfAttention.attention).

    mask: optional [B, T] key-validity mask (1=valid); masked logits are set
    to -1e30 before the exp (the reference multiplies after the exp,
    attention.py:40-41, but never passes a mask).
    """
    B, T, D = x.shape
    dk = D // num_heads
    # f32 at least (the parity path), f64 for an f64 reference
    xf = x if x.dtype == torch.float64 else x.float()
    q = xf @ params["wq"] + params["bq"]
    k = xf @ params["wk"] + params["bk"]
    v = xf @ params["wv"] + params["bv"]
    scale = math.sqrt(dk)

    if T <= 16:
        # small-T path (the interval axis, T = graph_num ≤ 12, and the
        # pooled sequence, T = 1): broadcast-multiply-reduce, the same
        # arithmetic as the JAX package's small-T path
        qh = q.reshape(B, T, num_heads, dk)
        kh = k.reshape(B, T, num_heads, dk)
        vh = v.reshape(B, T, num_heads, dk)
        logits = torch.sum(qh[:, :, None] * kh[:, None, :], dim=-1) / scale
        if mask is not None:                       # logits: [B, T, S, H]
            logits = torch.where(mask[:, None, :, None] > 0, logits,
                                 torch.full_like(logits, -1e30))
        if stable:
            attn = torch.softmax(logits, dim=2)
        else:
            scores = torch.exp(logits)             # attention.py:39
            attn = scores / (torch.sum(scores, dim=2, keepdim=True) + 1e-8)
        ctx = torch.sum(attn[..., None] * vh[:, None], dim=2)  # [B,T,H,dk]
        return ctx.reshape(B, T, D).to(x.dtype)

    def split_heads(y):  # [B, T, D] -> [B, H, T, dk]
        return y.reshape(B, T, num_heads, dk).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    logits = torch.einsum("bhtd,bhsd->bhts", q, k) / scale
    if mask is not None:
        logits = torch.where(mask[:, None, None, :] > 0, logits,
                             torch.full_like(logits, -1e30))
    if stable:
        attn = torch.softmax(logits, dim=-1)
    else:
        scores = torch.exp(logits)  # attention.py:39
        attn = scores / (torch.sum(scores, dim=-1, keepdim=True) + 1e-8)
    ctx = torch.einsum("bhts,bhsd->bhtd", attn, v)
    return ctx.transpose(1, 2).reshape(B, T, D).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """tf.contrib.layers.layer_norm with its DEFAULTS: mean/variance over ALL
    axes after the leading batch axis (for [N, T, D] inputs that is T·D
    jointly), scale/shift per last axis, variance_epsilon=1e-12
    (model.py:152-153,161-162,165)."""
    axes = tuple(range(1, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * scale + shift
