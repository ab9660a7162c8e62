"""Plain PyTorch reference of SelfGNN with the sequence encoder attending
per token, as the SelfGNN paper (SIGIR 2024) describes its sequence
encoder: the `SelfGNN` of `selfgnn.py` with its `sequence` replaced.
Float32, TF32 off unless a caller asks for it; it imports nothing of the
program.

The branch, for a batch of item sequences seq [B, L] (ids, left-padded
with id 0) and their mask [B, L] (1 on a real item):

    e   = final_item[seq]                                  [B, L, D]
    x   = (LN(e) + LN(pos_embed)) * mask                   [B, L, D]
    for each of att_layer blocks:
        x = leakyReLU(MHSA(LN(x), key mask)) + x
    out = sum over l of x[:, l] * mask[:, l]               [B, D]

LN is TF1's layer norm with its defaults: moments jointly over every axis
but the first (here the L·D of a row), scale and shift per width, eps
1e-12; the positions' LN is taken once over [1, L, D]. MHSA has dense Q,
K, V with biases, 16 heads of width D / heads, the max-subtracted softmax
over the keys with a masked key's logit set to -1e30 before it, the heads
concatenated and no output projection.

Departures from the paper, each as the released code or the program's
documented fix has it:
  * the paper's encoder is SASRec-like; the released model.py pools the
    sequence to one token before its attention (quirk Q3), and this file
    is the per-token fix, so neither is followed to the letter;
  * no causal mask: every real query attends to every real key (the
    released attention module, Utils/attention.py, has none either);
  * padded slots gather item 0's embedding (the sampler pads with id 0)
    and take part in every layer norm's moments; they are zeroed by the
    mask before the first block only, so after it they carry values,
    which later layer norms see, and the final sum drops them;
  * no dropout in the branch, no feed-forward sublayer, no output
    projection, a leakyReLU on the attention output (model.py's blocks);
  * the stable softmax where model.py takes the raw exp (quirk Q5);
  * a row with no real item attends uniformly over all its (masked)
    keys, and its sum is zero.
"""

from __future__ import annotations

import math

import torch

from .selfgnn import SelfGNN, joint_layer_norm, leaky, sub

MASKED_LOGIT = -1e30


def masked_attention(p, x: torch.Tensor, mask: torch.Tensor,
                     heads: int) -> torch.Tensor:
    """[B, T, D] -> [B, T, D]: Q, K, V with biases, per head the softmax
    (max subtracted) of q·k / sqrt(dk) over the keys with a masked key's
    logit at -1e30, the heads concatenated."""
    B, T, D = x.shape
    dk = D // heads
    q = (x @ p["wq"] + p["bq"]).view(B, T, heads, dk)
    k = (x @ p["wk"] + p["bk"]).view(B, T, heads, dk)
    v = (x @ p["wv"] + p["bv"]).view(B, T, heads, dk)
    logits = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(dk)
    keep = (mask > 0)[:, None, None, :]
    logits = torch.where(keep, logits,
                         torch.full_like(logits, MASKED_LOGIT))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bshd->bthd", w, v).reshape(B, T, D)


class SelfGNNSeq(SelfGNN):
    """The reference model with the per-token sequence branch."""

    def attend(self, p, x: torch.Tensor, mask: torch.Tensor
               ) -> torch.Tensor:
        """One block's attention over the window, masked keys left out."""
        return masked_attention(p, x, mask, self.m["num_heads"])

    def sequence(self, p, final_item: torch.Tensor, seq: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        m = self.m
        emb = final_item[seq.long()]                            # [B, L, D]
        a, b = sub(p, "free/seq_ln_item"), sub(p, "free/seq_ln_pos")
        pos = joint_layer_norm(p["reg/pos_embed"][None], b["scale"],
                               b["shift"])                      # [1, L, D]
        x = (joint_layer_norm(emb, a["scale"], a["shift"]) + pos) \
            * mask[:, :, None]
        for n in range(m["att_layer"]):
            ln = sub(p, f"free/seq_ln/{n}")
            h = self.attend(sub(p, f"free/seq_mhsa/{n}"),
                            joint_layer_norm(x, ln["scale"], ln["shift"]),
                            mask)
            x = leaky(h, m["leaky"]) + x
        return (x * mask[:, :, None]).sum(dim=1)
