"""Ring self-attention: sequence-parallel MHSA over a mesh's 'model' axis;
the port of `sagnn_tpu/parallel/ring_attention.py`.

The per-token sequence branch (`per_token_seq_attention`) attends over
every token of the [B, L, D] sequence. With `seq_parallel` the sequence
axis is split over the model ranks of one data rank, L/M tokens each, and
the attention is blockwise (Liu & Abbeel's ring attention, bidirectional
and masked, no causality):

  * Each model rank keeps its query block [B, L/M, D] on its device and
    carries a streaming softmax: the running row max `m`, the denominator
    `l` and the numerator `acc`.
  * The K, V and mask blocks go once around the model row, packed into
    one flat buffer per rank: at step s rank p holds the buffer of rank
    (p - s) mod M and folds it into its softmax, while it moves on to
    rank p + 1 (`parallel/edge_partition.exchange`, a copy into a new
    buffer even when every rank is on one card, as a ppermute always
    moves data). One buffer is one copy and one event a step: the
    receiver reads K, V and mask only after that event. M - 1 exchanging
    steps and a last local one: the last rotation is never sent.
  * Masked logits are -1e30 (JAX's NEG), so a masked key adds
    exp(-1e30 - m) = 0 and the streaming rescale reproduces the dense
    max-subtracted softmax (`ops.attention.multi_head_self_attention(
    stable=True, mask=...)`) up to the order of the f32 sums.
  * The gradients go back along the reverse ring: autograd through the
    exchanges' copies sends each block's gradient back to the device it
    came from, which is what JAX's transposed ppermute does.

One process drives the grid (`parallel/mesh.py`): the 'model' axis stays
inside a process, so a mesh that spans processes needs nothing across
them here. JAX computes this with plain ops outside any Pallas kernel, and
so does the port (torch.einsum); there is no kernel to write.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from sagnn_tpu_torch.parallel.edge_partition import exchange
from sagnn_tpu_torch.parallel.mesh import Mesh

NEG = -1e30  # masked-logit value, matching ops.attention


def _local_ring_attention(params: Dict[str, torch.Tensor],
                          xs: Sequence[torch.Tensor],
                          masks: Sequence[torch.Tensor], num_heads: int,
                          devices: Sequence[torch.device]
                          ) -> List[torch.Tensor]:
    """The ring over len(devices) model ranks (JAX `_local_ring_attention`,
    ring_attention.py:44-105, for every rank at once): xs[p] [B, Lq, D] and
    masks[p] [B, Lq] are rank p's query block and key mask, on
    devices[p]. Returns rank p's attention output [B, Lq, D] on its
    device, in xs[p]'s dtype. One rank is JAX's degenerate ring: a single
    local step, nothing exchanged."""
    M = len(devices)
    B, Lq, D = xs[0].shape
    dk = D // num_heads
    # JAX computes in f32 whatever x is (ring_attention.py:52): a bf16 x
    # widens, and bf16 parameters widen with it (jnp's f32 @ bf16 is f32);
    # an f64 x (a reference) stays f64
    acc_dtype = torch.float64 if xs[0].dtype == torch.float64 \
        else torch.float32
    scale = 1.0 / math.sqrt(dk)

    def heads(y):  # [B, L, D] -> [B, H, L, dk]
        return y.reshape(B, -1, num_heads, dk).transpose(1, 2)

    n = B * num_heads * Lq * dk     # elements of one K (or V) block

    def unpack(buf):  # one rank's flat buffer -> its K, V and mask blocks
        return (buf[:n].view(B, num_heads, Lq, dk),
                buf[n:2 * n].view(B, num_heads, Lq, dk),
                buf[2 * n:].view(B, Lq))

    q, kv = [], []
    for x, mk, dv in zip(xs, masks, devices):
        w = {k: v.to(dv, acc_dtype) for k, v in params.items()}
        xf = x.to(acc_dtype)
        q.append(heads(xf @ w["wq"] + w["bq"]))
        kv.append(torch.cat([heads(xf @ w["wk"] + w["bk"]).reshape(-1),
                             heads(xf @ w["wv"] + w["bv"]).reshape(-1),
                             mk.reshape(-1).to(acc_dtype)]))

    def accumulate(p, buf, m, l, acc):
        k_blk, v_blk, m_blk = unpack(buf)
        logits = torch.einsum("bhqd,bhsd->bhqs", q[p], k_blk) * scale
        logits = torch.where(m_blk[:, None, None, :] > 0, logits,
                             torch.full_like(logits, NEG))
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        r = torch.exp(m - m_new)                          # [B, H, Lq]
        e = torch.exp(logits - m_new[..., None])          # [B, H, Lq, Ls]
        l = l * r + torch.sum(e, dim=-1)
        acc = acc * r[..., None] + torch.einsum("bhqs,bhsd->bhqd", e, v_blk)
        return m_new, l, acc

    state = [(torch.full((B, num_heads, Lq), float("-inf"), dtype=acc_dtype,
                         device=dv),
              torch.zeros((B, num_heads, Lq), dtype=acc_dtype, device=dv),
              torch.zeros((B, num_heads, Lq, dk), dtype=acc_dtype,
                          device=dv)) for dv in devices]
    # held[p]: the packed buffer rank p holds and the event after which it
    # may read it (None: already readable)
    held = [(buf, None) for buf in kv]
    for s in range(M):
        sent = [None] * M
        if s < M - 1:
            # send early: the copy runs on a side stream, after the buffer's
            # own arrival, while the buffer held is reduced
            for p in range(M):
                buf, ready = held[p]
                sent[(p + 1) % M] = exchange(buf, devices[(p + 1) % M],
                                             ready)
        for p in range(M):
            buf, ready = held[p]
            if ready is not None:
                torch.cuda.current_stream(devices[p]).wait_event(ready)
            state[p] = accumulate(p, buf, *state[p])
        held = sent
    out = []
    for x, (m, l, acc) in zip(xs, state):
        o = acc / torch.clamp_min(l, 1e-38)[..., None]    # [B, H, Lq, dk]
        out.append(o.transpose(1, 2).reshape(B, Lq, D).to(x.dtype))
    return out


def ring_multi_head_self_attention(mesh: Mesh,
                                   params: Dict[str, torch.Tensor],
                                   x: torch.Tensor, num_heads: int,
                                   mask: torch.Tensor) -> torch.Tensor:
    """Sequence-parallel drop-in for `multi_head_self_attention(stable=True,
    mask=mask)` (JAX `ring_multi_head_self_attention`, ring_attention.py:
    108-140) over one data rank's model row: x [B, L, D] and mask [B, L]
    (1 = a valid key) on one device are cut into mesh.model_devices'
    blocks of L/M tokens, block p sent to model rank p; the projections
    run per rank (the weights copied to each) and the K/V blocks stream
    around the ring. Returns [B, L, D] on x's device. ValueError unless
    the 'model' axis divides L."""
    devices = mesh.model_devices
    M = len(devices)
    L = x.shape[1]
    if L % M:
        raise ValueError(f"sequence length {L} must divide the 'model' axis "
                         f"({M})")
    xs = [b.to(dv) for b, dv in zip(x.split(L // M, dim=1), devices)]
    masks = [b.to(dv) for b, dv in zip(mask.split(L // M, dim=1), devices)]
    out = _local_ring_attention(params, xs, masks, num_heads, devices)
    return torch.cat([o.to(x.device) for o in out], dim=1)
