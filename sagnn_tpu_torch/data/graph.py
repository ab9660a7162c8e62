"""Interval graphs as padded, target-sorted COO, their edge weights and
the permutation between the two directions' edge orders; the port's copy
of `sagnn_tpu/data/graph.py` (without `edge_weights_canonical`, which
exists for the TPU's chunk layout: the port keeps each direction's
weights in that direction's own COO order).

All `graph_num` interval graphs are padded to ONE common edge count `E` (a
multiple of `pad_multiple`), giving `[g, E]` int32 index arrays; the JAX
package needs that for one compiled shape, and the port keeps the layout
so the two packages see byte-equal inputs.

Conventions (as in the JAX package):
  * Edges are sorted by target id within each interval (ascending), the
    CSR row-major order the reference's `segment_sum` relies on (Q9).
    Padding edges come last with `tgt = num_targets` (a dump row) and
    `src = 0`, so sortedness holds.
  * The parity path is unweighted (Q1/Q2): the COO stores no edge values.
    Degree-normalised weights (`edge_weights`) and the cross-direction
    permutation (`direction_permutation`) serve the non-parity variants
    (`edge_norm`, `edge_dropout_keep`, `edge_attention`).
  * An empty interval becomes all padding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import scipy.sparse as sp


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class IntervalGraphs:
    """Padded COO edge blocks for all intervals, in both directions.

    u_*: item→user aggregation (the reference's subAdj[k], model.py:122)
    i_*: user→item aggregation (the reference's subTpAdj[k], model.py:123)
    """

    num_users: int
    num_items: int
    # [g, E] arrays. Sources hold real node ids; targets are sorted per row
    # with padding entries equal to num_targets.
    u_src: np.ndarray  # item ids feeding each user
    u_tgt: np.ndarray  # user ids (sorted; pad = num_users)
    i_src: np.ndarray  # user ids feeding each item
    i_tgt: np.ndarray  # item ids (sorted; pad = num_items)
    edge_counts: np.ndarray  # [g] true (unpadded) edge count per interval

    @property
    def graph_num(self) -> int:
        return self.u_src.shape[0]

    @property
    def edges_padded(self) -> int:
        return self.u_src.shape[1]

    @property
    def total_edges(self) -> int:
        return int(self.edge_counts.sum())


def _pad_coo(src: np.ndarray, tgt: np.ndarray, n_edges: int,
             pad_tgt: int) -> tuple[np.ndarray, np.ndarray]:
    e = len(src)
    out_src = np.zeros(n_edges, dtype=np.int32)
    out_tgt = np.full(n_edges, pad_tgt, dtype=np.int32)
    out_src[:e] = src
    out_tgt[:e] = tgt
    return out_src, out_tgt


def compile_interval_graphs(
    sub_mats: Sequence[sp.spmatrix],
    pad_multiple: int = 512,
    edges_padded: int | None = None,
) -> IntervalGraphs:
    """Compile `graph_num` U×I sparse interval matrices into padded blocks.

    Both directions are emitted: user-target edges sorted by user id and
    item-target edges sorted by item id (the transpose graph, ref
    model.py:235-236).
    """
    if len(sub_mats) == 0:
        raise ValueError("compile_interval_graphs needs at least one matrix")
    num_users, num_items = sub_mats[0].shape
    coos = [sp.coo_matrix(m) for m in sub_mats]
    counts = np.array([c.nnz for c in coos], dtype=np.int64)
    E = edges_padded or max(pad_multiple,
                            _round_up(int(counts.max(initial=1)), pad_multiple))
    if int(counts.max(initial=0)) > E:
        raise ValueError(
            f"edges_padded={E} smaller than max interval nnz {counts.max()}")

    u_src, u_tgt, i_src, i_tgt = [], [], [], []
    for c in coos:
        rows = c.row.astype(np.int32)
        cols = c.col.astype(np.int32)
        # user-direction: target=user(row), source=item(col); sort by row.
        # Stable sort keeps column order within a row (CSR row-major parity).
        order = np.argsort(rows, kind="stable")
        s, t = _pad_coo(cols[order], rows[order], E, num_users)
        u_src.append(s)
        u_tgt.append(t)
        # item-direction: target=item(col), source=user(row); sort by col.
        order = np.argsort(cols, kind="stable")
        s, t = _pad_coo(rows[order], cols[order], E, num_items)
        i_src.append(s)
        i_tgt.append(t)

    return IntervalGraphs(
        num_users=num_users,
        num_items=num_items,
        u_src=np.stack(u_src),
        u_tgt=np.stack(u_tgt),
        i_src=np.stack(i_src),
        i_tgt=np.stack(i_tgt),
        edge_counts=counts,
    )


def edge_weights(g: IntervalGraphs, sub_mats: Sequence[sp.spmatrix],
                 norm: str = "sym_sqrt") -> np.ndarray:
    """[2, g, E] float32 edge weights for the non-parity variants:
    weights[0] aligned with u_src/u_tgt, weights[1] with i_src/i_tgt; pad
    slots hold 0.

    norms:
      * "sym_sqrt": what `transToLsts(norm=True)` computes before the int32
        truncation destroys it (DataHandler.py:53-59),
        w = 1/(sqrt(row_deg)+eps) * 1/(sqrt(col_deg)+eps); the same value
        for both directions of an edge.
      * "mean": 1/target degree (GraphSAGE-mean). Direction-dependent: the
        user-target hop's weight is 1/user_deg, the item-target hop's
        1/item_deg.
    """
    if norm not in ("sym_sqrt", "mean"):
        raise ValueError(norm)
    E = g.edges_padded
    out = np.zeros((2, g.graph_num, E), dtype=np.float32)
    for k, m in enumerate(sub_mats):
        c = sp.coo_matrix(m)
        binary = sp.coo_matrix((np.ones(c.nnz), (c.row, c.col)),
                               shape=m.shape)
        row_deg = np.asarray(binary.sum(axis=1)).ravel()
        col_deg = np.asarray(binary.sum(axis=0)).ravel()
        if norm == "sym_sqrt":
            rd = 1.0 / (np.sqrt(row_deg + 1e-8) + 1e-8)
            cd = 1.0 / (np.sqrt(col_deg + 1e-8) + 1e-8)
            w_u = w_i = rd[c.row] * cd[c.col]
        else:
            w_u = 1.0 / np.maximum(row_deg, 1.0)[c.row]
            w_i = 1.0 / np.maximum(col_deg, 1.0)[c.col]
        order = np.argsort(c.row.astype(np.int32), kind="stable")
        out[0, k, : c.nnz] = w_u[order]
        order = np.argsort(c.col.astype(np.int32), kind="stable")
        out[1, k, : c.nnz] = w_i[order]
    return out


def direction_permutation(g: IntervalGraphs,
                          sub_mats: Sequence[sp.spmatrix]) -> np.ndarray:
    """[g, E] int32: for each i-direction edge slot, the u-direction slot of
    the same (user, item) edge; pad slots map to themselves. So a per-edge
    array in u-order becomes i-order as `a_u[perm]`.

    Both directions come from one COO through stable argsorts (by row for
    u, by column for i), so composing the two orders gives the exact
    correspondence."""
    E = g.edges_padded
    out = np.tile(np.arange(E, dtype=np.int32), (g.graph_num, 1))
    for k, m in enumerate(sub_mats):
        c = sp.coo_matrix(m)
        order_u = np.argsort(c.row.astype(np.int32), kind="stable")
        order_i = np.argsort(c.col.astype(np.int32), kind="stable")
        inv_u = np.empty(c.nnz, np.int32)
        inv_u[order_u] = np.arange(c.nnz, dtype=np.int32)
        out[k, : c.nnz] = inv_u[order_i]
    return out


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    """[g, E] int32 inverse of each row of `perm` (for
    `direction_permutation`: each u-direction slot's i-direction slot)."""
    inv = np.empty_like(perm)
    rows = np.arange(perm.shape[0])[:, None]
    inv[rows, perm] = np.arange(perm.shape[1], dtype=perm.dtype)[None, :]
    return inv


def build_user_item_csr(sequences: List[List[int]], num_users: int,
                        num_items: int) -> sp.csr_matrix:
    """Binary U×I train matrix from per-user item sequences.

    Mirrors `generate_rating_matrix_test` (DataHandler.py:109-125): every
    (user, item) occurrence contributes 1 (duplicates sum, as in the
    reference's csr_matrix construction).
    """
    rows, cols = [], []
    for uid, items in enumerate(sequences):
        rows.extend([uid] * len(items))
        cols.extend(items)
    data = np.ones(len(rows), dtype=np.int64)
    return sp.csr_matrix((data, (np.array(rows), np.array(cols))),
                         shape=(num_users, num_items))
