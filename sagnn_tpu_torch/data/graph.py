"""Interval graphs as padded, target-sorted COO; the port's copy of
`sagnn_tpu/data/graph.py` (the parity subset: no edge weights yet).

All `graph_num` interval graphs are padded to ONE common edge count `E` (a
multiple of `pad_multiple`), giving `[g, E]` int32 index arrays; the JAX
package needs that for one compiled shape, and the port keeps the layout
so the two packages see byte-equal inputs.

Conventions (as in the JAX package):
  * Edges are sorted by target id within each interval (ascending), the
    CSR row-major order the reference's `segment_sum` relies on (Q9).
    Padding edges come last with `tgt = num_targets` (a dump row) and
    `src = 0`, so sortedness holds.
  * Propagation is unweighted (Q1/Q2): no edge values are stored.
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
