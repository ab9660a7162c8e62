"""Message propagation in plain PyTorch: gather + sorted segment-sum; the
port's copy of `sagnn_tpu/ops/segment.py`.

This is the "xla" propagation backend and the plain version of the CUDA
segment-sum kernel (`ops/spmm_cuda.py`).

Reference semantics (model.py:80-92 `messagePropagate`): an UNWEIGHTED sum
over in-edges (Q1/Q2) followed by the leaky-relu. Padded edges carry
tgt == num_targets, so the sum runs into num_targets+1 rows and the dump
row is dropped.
"""

from __future__ import annotations

import torch


def gather_segment_sum(src_emb: torch.Tensor, src: torch.Tensor,
                       tgt: torch.Tensor, num_tgt: int) -> torch.Tensor:
    """out[t, :] = sum_{e: tgt[e]==t} src_emb[src[e], :].

    src_emb: [N_src, D]; src, tgt: [E] int32/int64 (pad tgt = num_tgt);
    returns [num_tgt, D]. On the CPU the sum runs in edge order; on a card
    `index_add_` uses atomics, so the order (and the last bits) vary.
    """
    msgs = src_emb.index_select(0, src)
    out = torch.zeros((num_tgt + 1, src_emb.shape[1]), dtype=msgs.dtype,
                      device=msgs.device)
    out.index_add_(0, tgt, msgs)
    return out[:num_tgt]


def propagate(src_emb: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
              num_tgt: int, leaky: float) -> torch.Tensor:
    """One reference propagation hop incl. the leaky-relu (model.py:92)."""
    agg = gather_segment_sum(src_emb, src, tgt, num_tgt)
    return torch.maximum(leaky * agg, agg)
