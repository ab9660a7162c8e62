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

The small-T attention core (T ≤ 16: the fusion stack's interval axis and
the pooled sequence branch's single token) runs, for unmasked f32 calls on
the card, on one hand-written CUDA kernel pair
(`csrc/interval_attention.cu`: `interval_attention`, its backward
`interval_attention_backward`, `IntervalAttentionFunction`), which keeps
the [T, T] scores in registers; the JAX package leaves this path to XLA,
so it replaces no Pallas kernel. Its plain versions,
`interval_attention_plain` (today's broadcast-multiply-reduce) and
`interval_attention_backward_plain` (the backward kernel's arithmetic),
run for CPU tensors, and the plain path for f64, masked calls and T > 16.

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
from sagnn_tpu_torch.ops.spmm_cuda import _launch


# Kernel launches of the interval attention kernel pair
# (`csrc/interval_attention.cu`), incremented only where a launch happens;
# "_bwd" counts the launches of `IntervalAttentionFunction.backward`.
LAUNCHES = {"interval_mhsa_f32": 0, "interval_mhsa_f32_bwd": 0}

# The shapes the kernels take: T up to KERNEL_MAX_T, a head size in
# KERNEL_HEAD_DIMS (template parameters of the source), one node's [T, D]
# at most MAX_NODE_FLOATS floats (its shared-memory tile; `_build` passes
# the bound to the source).
KERNEL_MAX_T = 16
KERNEL_HEAD_DIMS = (1, 2, 4, 8, 16)
MAX_NODE_FLOATS = 4096


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# Work of the masked einsum path (T > 16: the per-token sequence
# attention), from shapes alone, no sync: "calls" the rows attended (B a
# call), "slots" their B·T tokens, "pairs" their B·T² (query, key) pairs,
# padding included.
SEQ_ATTENTION = {"calls": 0, "slots": 0, "pairs": 0}


def reset_seq_attention() -> None:
    for name in SEQ_ATTENTION:
        SEQ_ATTENTION[name] = 0


def multi_head_self_attention(params: Dict[str, torch.Tensor],
                              x: torch.Tensor, num_heads: int,
                              stable: bool = False,
                              mask: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """x: [B, T, D] -> [B, T, D] (ref MultiHeadSelfAttention.attention).

    mask: optional [B, T] key-validity mask (1=valid); masked logits are set
    to -1e30 before the exp (the reference multiplies after the exp,
    attention.py:40-41, but never passes a mask).

    The attention core of an unmasked call on f32 CUDA tensors, T ≤ 16,
    runs on the interval attention kernels (`interval_attention`, with
    `IntervalAttentionFunction` where autograd records); every other call,
    and every call on the CPU, on the plain small-T path or, past T = 16,
    on the einsum path.
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

    if _takes_kernel(q, num_heads, mask):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            ctx = IntervalAttentionFunction.apply(q, k, v, num_heads, stable)
        else:
            ctx = interval_attention(q, k, v, num_heads, stable)
        return ctx.to(x.dtype)
    if T <= 16:
        # small-T path (the interval axis, T = graph_num ≤ 12, and the
        # pooled sequence, T = 1): the same arithmetic as the JAX package's
        # small-T path
        return interval_attention_plain(q, k, v, num_heads, stable,
                                        mask).to(x.dtype)

    def split_heads(y):  # [B, T, D] -> [B, H, T, dk]
        return y.reshape(B, T, num_heads, dk).transpose(1, 2)

    if mask is not None:
        SEQ_ATTENTION["calls"] += B
        SEQ_ATTENTION["slots"] += B * T
        SEQ_ATTENTION["pairs"] += B * T * T
    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    logits = torch.einsum("bhtd,bhsd->bhts", q, k) / math.sqrt(dk)
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


def _takes_kernel(q: torch.Tensor, num_heads: int,
                  mask: torch.Tensor | None) -> bool:
    """Whether the kernels take this call: f32 on a CUDA device, no mask,
    and a shape they take."""
    _, T, D = q.shape
    return (q.is_cuda and q.dtype == torch.float32 and mask is None
            and T <= KERNEL_MAX_T and D // num_heads in KERNEL_HEAD_DIMS
            and T * D <= MAX_NODE_FLOATS)


def _split_heads(num_heads: int, *ts: torch.Tensor) -> list[torch.Tensor]:
    """[B, T, D] -> [B, T, H, dk] each."""
    B, T, D = ts[0].shape
    return [t.reshape(B, T, num_heads, D // num_heads) for t in ts]


def interval_attention_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, num_heads: int,
                             stable: bool = False,
                             mask: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The attention core of the small-T path, q, k, v [B, T, D] ->
    ctx [B, T, D]: broadcast-multiply-reduce, the plain version of the
    interval attention kernel (and, with a mask, the masked small-T path).
    """
    B, T, D = q.shape
    qh, kh, vh = _split_heads(num_heads, q, k, v)
    scale = math.sqrt(D // num_heads)
    logits = torch.sum(qh[:, :, None] * kh[:, None, :], dim=-1) / scale
    if mask is not None:                           # logits: [B, T, S, H]
        logits = torch.where(mask[:, None, :, None] > 0, logits,
                             torch.full_like(logits, -1e30))
    if stable:
        attn = torch.softmax(logits, dim=2)
    else:
        scores = torch.exp(logits)                 # attention.py:39
        attn = scores / (torch.sum(scores, dim=2, keepdim=True) + 1e-8)
    ctx = torch.sum(attn[..., None] * vh[:, None], dim=2)   # [B,T,H,dk]
    return ctx.reshape(B, T, D)


def interval_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, g: torch.Tensor,
                                      num_heads: int, stable: bool = False
                                      ) -> tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """dq, dk, dv of `interval_attention_plain` (no mask) for the cotangent
    g of its output, each [B, T, D]: the backward kernel's arithmetic, the
    scores recomputed, then per node and head
    da[t, s] = g[t]·v[s], c[t] = Σ_s p[t, s] da[t, s],
    dl = p (da - c) / sqrt(dk), dq[t] = Σ_s dl k[s], dk[s] = Σ_t dl q[t],
    dv[s] = Σ_t p[t, s] g[t]. Both normalisations share dl: for
    p = e / (Σ e + ε), dp/dl = diag(p) - p pᵀ, as for the softmax."""
    B, T, D = q.shape
    qh, kh, vh, gh = _split_heads(num_heads, q, k, v, g)
    scale = math.sqrt(D // num_heads)
    logits = torch.sum(qh[:, :, None] * kh[:, None, :], dim=-1) / scale
    if stable:
        p = torch.softmax(logits, dim=2)           # [B, T, S, H]
    else:
        e = torch.exp(logits)
        p = e / (torch.sum(e, dim=2, keepdim=True) + 1e-8)
    da = torch.sum(gh[:, :, None] * vh[:, None, :], dim=-1)
    c = torch.sum(p * da, dim=2, keepdim=True)
    dl = p * (da - c) / scale
    dq = torch.sum(dl[..., None] * kh[:, None, :], dim=2)
    dkey = torch.sum(dl[..., None] * qh[:, :, None], dim=1)
    dv = torch.sum(p[..., None] * gh[:, :, None], dim=1)
    return tuple(t.reshape(B, T, D) for t in (dq, dkey, dv))


def _check_kernel_args(num_heads: int, **ts: torch.Tensor) -> None:
    """Raise on what the kernels do not take: each tensor a contiguous,
    16-byte aligned f32 [N, T, D] on one CUDA device, all of one shape,
    T ≤ KERNEL_MAX_T, D / num_heads in KERNEL_HEAD_DIMS, T·D ≤
    MAX_NODE_FLOATS."""
    first = next(iter(ts.values()))
    if first.dim() != 3:
        raise ValueError(f"q must be [N, T, D], got {tuple(first.shape)}")
    N, T, D = first.shape
    for name, t in ts.items():
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does "
                             f"not match q {tuple(first.shape)} on "
                             f"{first.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if num_heads <= 0 or D % num_heads or \
            D // num_heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernels take a head size in "
                         f"{KERNEL_HEAD_DIMS}, got D {D} over {num_heads} "
                         "heads")
    if not 1 <= T <= KERNEL_MAX_T or T * D > MAX_NODE_FLOATS:
        raise ValueError(f"the kernels take 1 <= T <= {KERNEL_MAX_T} and "
                         f"T x D <= {MAX_NODE_FLOATS}, got T {T}, D {D}")
    if N >= 2 ** 31:
        raise ValueError("the kernels count nodes with int32")


def interval_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       num_heads: int, stable: bool = False) -> torch.Tensor:
    """ctx [N, T, D] of q, k, v [N, T, D]: on a CUDA tensor one launch of
    the forward kernel (or a raise on what it does not take); on the CPU
    `interval_attention_plain`."""
    if not q.is_cuda:
        return interval_attention_plain(q, k, v, num_heads, stable)
    _check_kernel_args(num_heads, q=q, k=k, v=v)
    ctx = torch.empty_like(q)
    N, T, D = q.shape
    if N:
        _launch("interval_mhsa_f32", q.device, False, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), ctx.data_ptr(), N, T, D,
                D // num_heads, int(stable), launches=LAUNCHES)
    return ctx


def interval_attention_backward(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, g: torch.Tensor,
                                num_heads: int, stable: bool = False
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """dq, dk, dv [N, T, D] of `interval_attention` for the cotangent g: on
    a CUDA tensor one launch of the backward kernel, which recomputes the
    scores (or a raise on what it does not take); on the CPU
    `interval_attention_backward_plain`."""
    if not q.is_cuda:
        return interval_attention_backward_plain(q, k, v, g, num_heads,
                                                 stable)
    _check_kernel_args(num_heads, q=q, k=k, v=v, g=g)
    dq, dkey, dv = (torch.empty_like(q) for _ in range(3))
    N, T, D = q.shape
    if N:
        _launch("interval_mhsa_bwd_f32", q.device, True, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
                dkey.data_ptr(), dv.data_ptr(), N, T, D, D // num_heads,
                int(stable), count="interval_mhsa_f32", launches=LAUNCHES)
    return dq, dkey, dv


class IntervalAttentionFunction(torch.autograd.Function):
    """`interval_attention` with its backward kernel: saves q, k, v (no
    score or probability) and recomputes the scores in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, stable):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.stable = num_heads, stable
        return interval_attention(q, k, v, num_heads, stable)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*interval_attention_backward(q, k, v, g.contiguous(),
                                             ctx.num_heads, ctx.stable),
                None, None)


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
