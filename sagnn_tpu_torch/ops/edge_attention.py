"""Edge-scored (GAT-style) propagation: SDDMM → edge softmax → weighted
SpMM; the port of `sagnn_tpu/ops/edge_attention.py`.

  scores  = sddmm(x_src, x_tgt) / sqrt(D)     (K5, csrc/sddmm.cu)
  weights = edge_softmax(scores)              (plain PyTorch, per target)
  out     = spmm_weighted(x_src, weights)     (K2, csrc/segsum.cu)

Gradients flow end to end: `sddmm` and `spmm_weighted` are autograd
Functions whose backwards are K2 and K5; the softmax differentiates
through PyTorch. JAX runs the softmax in XLA, outside Pallas, so plain
PyTorch is its counterpart here.

Each hop runs in its own direction's CSR order (JAX runs both hops in
the u-direction's order, with unsorted item targets in the item-target
hop): the values agree up to the order of the sums. The per-target
reductions are CSR segment reductions over contiguous rows
(`torch.segment_reduce`), not atomics, so the card repeats its result bit
for bit.
"""

from __future__ import annotations

import torch

from sagnn_tpu_torch.ops.spmm_cuda import sddmm, spmm_weighted


def edge_softmax(scores: torch.Tensor, tgt: torch.Tensor,
                 ptr: torch.Tensor) -> torch.Tensor:
    """Per-target softmax over the incoming edges' scores (JAX
    `edge_softmax` with the real-edge mask).

    scores: [E] in the plan's edge order; tgt: [E] the plan's
    target-sorted COO targets (pad slots = num_tgt); ptr: [num_tgt + 1]
    its row pointers. Returns [E] weights: each real edge's softmax within
    its target row, 0 on the pad slots. A row without edges has no
    weights; the denominator is clamped at 1e-9 as in JAX. The row max is
    taken without a gradient: the softmax does not depend on the shift,
    so the gradient is the same."""
    num_tgt = ptr.numel() - 1
    # the pad slots form one more segment after the last row, so every
    # slot lies in a segment and no edge count is read back to the host
    lengths = torch.diff(ptr.long(), append=ptr.new_full((1,), scores.numel(),
                                                         dtype=torch.long))
    with torch.no_grad():
        m = torch.segment_reduce(scores, "max", lengths=lengths)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    t = tgt.long()
    z = torch.exp(scores - m.index_select(0, t))
    denom = torch.segment_reduce(z, "sum", lengths=lengths)
    w = z / torch.clamp_min(denom, 1e-9).index_select(0, t)
    return torch.where(t < num_tgt, w, torch.zeros_like(w))


def attention_propagate(x_src: torch.Tensor, x_tgt: torch.Tensor,
                        fwd_src: torch.Tensor, fwd_tgt: torch.Tensor,
                        fwd_ptr: torch.Tensor, bwd_src: torch.Tensor,
                        bwd_ptr: torch.Tensor, to_bwd: torch.Tensor,
                        temperature: float | None = None,
                        exact: bool = True) -> torch.Tensor:
    """One attention-weighted hop: out[t] = Σ_e softmax_t(s_e)·x_src[src_e]
    with s_e = x_src[src_e]·x_tgt[t] / temperature (default sqrt(D)).

    x_src [N_src, D], x_tgt [N_tgt, D]; the plans as `spmm_weighted`
    takes them (the forward plan's targets are x_tgt's rows, the
    transpose plan's x_src's)."""
    temp = float(x_src.shape[-1]) ** 0.5 if temperature is None \
        else temperature
    scores = sddmm(x_src, x_tgt, fwd_src, fwd_tgt, fwd_ptr, bwd_src,
                   bwd_ptr, to_bwd, exact) / temp
    w = edge_softmax(scores, fwd_tgt, fwd_ptr)
    return spmm_weighted(x_src, w, fwd_src, fwd_tgt, fwd_ptr, bwd_src,
                         bwd_ptr, to_bwd, exact)
