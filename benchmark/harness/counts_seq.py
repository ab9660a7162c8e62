"""Operations and bytes of the per-token sequence branch, from the log's
sequence lengths: the counts of `counts.py` for a step whose sequence
attention runs over every token of the [B, L, D] window.

A training row's window holds the user's train items up to the positive,
less the sampler's choice of positive (the c-th last of the user's train
items before the last, c uniform over 1 .. max(min(pred_num + 1, p - 3),
1), p the count of those items; `harness.train.check_batches`), at most
L of them: w = min(p - c, L) valid tokens and w² valid (query, key)
pairs. A row left empty at the end of an epoch holds none. Only valid
tokens and pairs are counted, so a kernel that skips the padding reads
below its bound.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from benchmark.harness import counts


def window_fill(lengths: np.ndarray, L: int, pred_num: int
                ) -> Tuple[float, float]:
    """(E[w], E[w²]) over the users and the sampler's choice of positive:
    lengths [U] each user's train items (its train sequence)."""
    p = np.asarray(lengths, np.int64) - 1        # the sequence's last held
    hi = np.maximum(np.minimum(pred_num + 1, p - 3), 1)
    tok = np.zeros(len(p))
    pair = np.zeros(len(p))
    for c in range(1, pred_num + 2):
        on = (c <= hi) & (p > 0)
        w = np.clip(p - c, 0, L).astype(np.float64)
        tok += np.where(on, w / hi, 0.0)
        pair += np.where(on, w * w / hi, 0.0)
    return float(tok.mean()), float(pair.mean())


def seq_layer_flops(d: int, tokens: float, pairs: float) -> float:
    """One per-token attention layer's forward FLOPs: q, k, v projections
    (3·2·D² a token) and the two products q·k and p·v (2·2·D a pair)."""
    return tokens * 3 * 2 * d * d + pairs * 2 * 2 * d


def train_step_flops(model: dict, train: dict, num_users: int,
                     num_items: int, edge_counts: Sequence[int],
                     tokens: float, pairs: float) -> float:
    """`counts.train_step_flops` with the pooled branch's products taken
    out and the per-token layers' put in, forward and backward (×3, as
    `counts` counts a product); tokens, pairs: valid ones a step."""
    B, L, D = train["batch"], model["pos_length"], model["latdim"]
    pooled = 2 * B * L * D * 2 + model["att_layer"] * B * (3 * 2 * D * D
                                                           + 2 * 2 * D)
    per_token = model["att_layer"] * seq_layer_flops(D, tokens, pairs)
    return counts.train_step_flops(model, train, num_users, num_items,
                                   edge_counts) + 3 * (per_token - pooled)


def seq_attention_bound_s(d: int, tokens: float, pairs: float) -> float:
    """The least time of one per-token attention call, forward and
    backward, over `tokens` valid tokens and `pairs` valid pairs: f32 q,
    k, v and the output read or written once forward (4 tokens·D floats),
    q, k, v, the cotangent, dq, dk and dv backward (7); 4·D FLOPs a pair
    forward (q·k and p·v), 8·D backward."""
    row = tokens * d * 4
    return (counts.bound_s(4 * row, 4 * d * pairs)
            + counts.bound_s(7 * row, 8 * d * pairs))
