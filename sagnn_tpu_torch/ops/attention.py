"""Multi-head self-attention with the reference's exp-score normalisation,
TF's layer norm and the additive attention pooling; the port of
`sagnn_tpu/ops/attention.py`.

Reference semantics (Utils/attention.py:31-78):
    W_Q/W_K/W_V: dense layers WITH bias (tf.layers.dense default)
    scores = exp(Q Kᵀ / sqrt(d_k))              — raw exp, NOT max-subtracted
    attn   = scores / (sum(scores, -1) + 1e-8)   — Q5
    out    = attn V, heads re-merged; no output projection, no residual.

Raw exp overflows for large logits, so the parity path runs in float32.
`stable=True` switches to the max-subtracted softmax. Parameters are dicts
with the JAX package's leaf names (wq, bq, wk, bk, wv, bv / scale, shift).

bf16 inputs (fusion_dtype="bf16") follow the JAX functions' dtype rules:
the attention casts x to f32 and multiplies it by the bf16 parameters,
which jnp promotes to f32, so q, k, v, the logits, the softmax and the
context are f32 computed from bf16-rounded weights, and only the output
goes back to bf16; the layer norm's mean and variance accumulate in f32
and are rounded to bf16 once (PyTorch's bf16 reductions do so), its
other ops run in bf16.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from sagnn_tpu_torch.models.layers import scalar_as, tf_glorot_uniform


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
    # f32 at least (the parity path), f64 for an f64 reference; bf16
    # parameters widen exactly, as jnp promotes f32 @ bf16 to f32
    xf = x if x.dtype == torch.float64 else x.float()
    w = {k: v.to(xf.dtype) for k, v in params.items()}
    q = xf @ w["wq"] + w["bq"]
    k = xf @ w["wk"] + w["bk"]
    v = xf @ w["wv"] + w["bv"]
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


def init_additive_attention_params(gen: torch.Generator, query_dim: int,
                                   cand_dim: int) -> Dict[str, torch.Tensor]:
    """AdditiveAttention (Utils/attention.py:4-29), dead in the reference
    model (model.py:147-148, 168): a dense layer to query_dim (xavier
    uniform w, zero b) and a query vector drawn uniform(-0.1, 0.1), which
    the reference keeps non-trainable and JAX keeps as a param. Draws
    come from `gen`."""
    query = torch.rand((query_dim, 1), generator=gen, device=gen.device)
    return {
        "w": tf_glorot_uniform(gen, (cand_dim, query_dim), gen.device),
        "b": torch.zeros((query_dim,), device=gen.device),
        "query": query * 0.2 - 0.1,
    }


def additive_attention(params: Dict[str, torch.Tensor],
                       candidates: torch.Tensor) -> torch.Tensor:
    """candidates [B, T, D] -> [B, D]: tanh(c w + b) scored against the
    query, softmax over T, the candidates pooled by those weights."""
    temp = torch.tanh(candidates @ params["w"] + params["b"])   # [B, T, Q]
    weights = torch.softmax((temp @ params["query"]).squeeze(-1), dim=1)
    return torch.einsum("bt,btd->bd", weights, candidates)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """tf.contrib.layers.layer_norm with its DEFAULTS: mean/variance over ALL
    axes after the leading batch axis (for [N, T, D] inputs that is T·D
    jointly), scale/shift per last axis, variance_epsilon=1e-12
    (model.py:152-153,161-162,165). For a bf16 x, PyTorch's mean and var
    accumulate in f32 and round to bf16 once, as jnp.mean and jnp.var do;
    the rest runs in x's dtype."""
    axes = tuple(range(1, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, unbiased=False)
    v = var + scalar_as(eps, x.dtype)
    if x.dtype in (torch.bfloat16, torch.float16):
        # one rounding of the f32 rsqrt, as XLA computes it (PyTorch's CPU
        # bf16 rsqrt is off by an ulp on some [N, 1, 1] inputs)
        inv = torch.rsqrt(v.float()).to(x.dtype)
    else:
        inv = torch.rsqrt(v)
    return (x - mean) * inv * scale + shift
