"""Operations and bytes computed from shapes, and the device's peaks.

The peaks and K1's byte count follow chip_smoke.py (`HBM_BYTES_PER_S`,
`F32_FLOPS`, the K1 record of `kernel_phase`, `_bound_ms`), copied here so
that the yardstick stays fixed; the source table is counted as the
distinct rows the plan reads rather than the whole table.

Model FLOPs count the matrix products (2 per multiply-add), the
segment-sums of propagation (1 per added value) and the sum of squares of
the reg term; elementwise work (activations, norms, softmax, the optimizer)
is not counted. Backward: twice the forward for a product (both operands'
gradients), once for a segment-sum (the transpose's sum), half the
forward's for the reg term (one multiply per element). Nothing is counted
twice for recomputation.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# NVIDIA H100 SXM (data sheet, dense): HBM bytes/s; f32 FLOP/s outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def segsum_bound_s(n_tgt: int, n_src_rows: int, edges: int, d: int,
                   elem: int = 4) -> float:
    """One K1 launch over a CSR plan: the distinct source rows once, the
    source ids and the row pointers once, the f32 output once; one add per
    gathered value."""
    nbytes = (n_src_rows * d * elem + edges * 4 + (n_tgt + 1) * 4
              + n_tgt * d * 4)
    return bound_s(nbytes, edges * d)


def k1_bound_s_per_step(edges: Sequence[np.ndarray], num_users: int,
                        num_items: int, d: int, gnn_layer: int) -> float:
    """K1's bound for one training step: every hop of every interval into
    both sides, forward and backward (a hop's backward is the segment-sum
    on the other side's plan). edges: per interval [2, E_k] pairs."""
    per_layer = 0.0
    for e in edges:
        n = e.shape[1]
        into_users = segsum_bound_s(num_users, len(np.unique(e[1])), n, d)
        into_items = segsum_bound_s(num_items, len(np.unique(e[0])), n, d)
        per_layer += into_users + into_items
    return 2 * gnn_layer * per_layer


def train_step_flops(model: dict, train: dict, num_users: int,
                     num_items: int, edge_counts: Sequence[int]) -> float:
    """Model FLOPs of one training step, forward and backward."""
    g, D, L = model["graph_num"], model["latdim"], model["pos_length"]
    s = model["ssldim"]
    N = num_users + num_items
    B = train["batch"]
    P = B * train["samp_num"]
    Pssl = B * train["ssl_num"]
    E = float(sum(edge_counts))
    prop = 2 * model["gnn_layer"] * E * D                 # segment-sums
    lstm = 2 * (2 * D) * (4 * D) * g * N                  # [x, h] @ kernel
    fusion = (3 * 2 * D * D * g + 2 * 2 * g * g * D) * N  # QKV, QK^T, AV
    seq = 2 * B * L * D * 2 + model["att_layer"] * B * (3 * 2 * D * D
                                                        + 2 * 2 * D)
    head = 2 * 2 * P * D                                  # pos and neg dots
    ssl = g * Pssl * (2 * (2 * 3 * D * s + 2 * s) + 4 * 2 * D)
    reg = 2 * (g * N * D + L * D + 2 * D + 2 * g * model["gnn_layer"] * D * D
               + 3 * D * s + s)
    products = lstm + fusion + seq + head + ssl
    return prop * 2 + products * 3 + reg * 1.5
