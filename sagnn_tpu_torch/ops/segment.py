"""Message propagation in plain PyTorch: gather + sorted segment-sum, with
optional per-edge weights; the port's copy of `sagnn_tpu/ops/segment.py`.

This is the "xla" propagation backend (unweighted, and the weighted
variants `edge_norm` / `edge_dropout_keep`) and the plain version of the
CUDA segment-sum kernels (`ops/spmm_cuda.py`: K1 unweighted, K2 weighted).

Reference semantics (model.py:80-92 `messagePropagate`): an UNWEIGHTED sum
over in-edges (Q1/Q2) followed by the leaky-relu. Padded edges carry
tgt == num_targets, so the sum runs into num_targets+1 rows and the dump
row is dropped.
"""

from __future__ import annotations

import torch


def gather_segment_sum(src_emb: torch.Tensor, src: torch.Tensor,
                       tgt: torch.Tensor, num_tgt: int,
                       weights: torch.Tensor | None = None) -> torch.Tensor:
    """out[t, :] = sum_{e: tgt[e]==t} w[e] * src_emb[src[e], :].

    src_emb: [N_src, D]; src, tgt: [E] int32/int64 (pad tgt = num_tgt);
    weights: optional [E]; returns [num_tgt, D]. On the CPU the sum runs in
    edge order; on a card `scatter_add_` uses atomics, so the order (and
    the last bits) vary.

    The add is `scatter_add_` with the index expanded to [E, D] (a
    stride-0 view), not `index_add_`: autograd keeps index_add_'s whole
    [E, D] source for its backward (5.5 GB per f32 hop at 21.4M edges),
    scatter_add_ only the index. The JAX package keeps no such tensor.
    """
    msgs = src_emb.index_select(0, src)
    if weights is not None:
        msgs = msgs * weights.to(msgs.dtype)[:, None]
    out = torch.zeros((num_tgt + 1, src_emb.shape[1]), dtype=msgs.dtype,
                      device=msgs.device)
    out.scatter_add_(0, tgt.long()[:, None].expand_as(msgs), msgs)
    return out[:num_tgt]


def propagate(src_emb: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
              num_tgt: int, leaky: float,
              weights: torch.Tensor | None = None) -> torch.Tensor:
    """One reference propagation hop incl. the leaky-relu (model.py:92)."""
    agg = gather_segment_sum(src_emb, src, tgt, num_tgt, weights)
    return torch.maximum(leaky * agg, agg)


def edge_dropout_weights(gen: torch.Generator, shape, keep_rate: float,
                         base: torch.Tensor | None = None) -> torch.Tensor:
    """Functional edge dropout for the non-parity variant: a Bernoulli edge
    mask scaled by 1/keep (what the reference's edgeDropout meant to do,
    model.py:93-102), times `base` when given. The mask is drawn from
    `gen` on its device (uniform < keep, as `jax.random.bernoulli`
    thresholds); the two frameworks' streams differ, so tests feed both the
    same mask."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    w = (u < keep_rate).to(torch.float32) / keep_rate
    return w if base is None else w * base
