"""Catalog-sharded serving: full-catalog top-k over item encodings split
across a mesh's 'model' axis; the port of `sagnn_tpu/parallel/serving.py`.

The distributed-MIPS decomposition, one process driving every rank:

  rank p:  scores = queries @ item_shard_p.T          [B, I/P]
           local (vals, ids) = top-k of its real rows [B, k_p]
  merge:   each rank's winners copied into new buffers on the mesh's
           first device (the all-gather)              [B, sum k_p]
           exact top-k of the candidates              [B, k]

The merge is exact: the global top-k is a subset of the per-rank top-ks.
What crosses ranks is O(P·B·k), whatever the catalog's size. Each rank
scores densely up to `ops.chunking.DENSE_MAX_ROWS` local rows and streams
its rows through `chunked_topk` past that, in local ids. The scores are a
plain product (`torch.matmul`), as JAX computes them outside any kernel.

Pad rows (`pad_catalog`) are never scored: each rank scores only its real
rows, the first clip(num_items - p·local, 0, local), and takes
k_p = min(k, real rows) winners, so a rank of pad rows alone offers no
candidate and no pad id can be returned while k <= num_items. Seen items
are masked to -inf, never by value.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from sagnn_tpu_torch.models.selfgnn import check_recall_target, chunked_topk
from sagnn_tpu_torch.ops.chunking import auto_chunk_rows, scatter_local_mask
from sagnn_tpu_torch.parallel.mesh import Mesh


def pad_catalog(table: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Pad item-encoding rows with zeros so the catalog splits evenly over
    `num_shards` (the pad rows are never scored)."""
    n = table.shape[0]
    target = -(-n // num_shards) * num_shards
    if target == n:
        return table
    return torch.cat([table, table.new_zeros((target - n,)
                                             + tuple(table.shape[1:]))])


def shard_catalog(mesh: Mesh, table: torch.Tensor) -> List[torch.Tensor]:
    """Split a (padded) catalog [Ip, D] into P row blocks, block p a new
    tensor on `mesh.model_devices[p]` (rows [p·Ip/P, (p+1)·Ip/P))."""
    devices = mesh.model_devices
    if table.shape[0] % len(devices):
        raise ValueError(f"{table.shape[0]} rows do not split over "
                         f"{len(devices)} shards (pad_catalog)")
    return [blk.to(dev, copy=True)
            for blk, dev in zip(table.chunk(len(devices)), devices)]


def sharded_topk(mesh: Mesh, queries: torch.Tensor,
                 item_table: List[torch.Tensor], num_items: int, k: int,
                 recall_target: float = 1.0,
                 seen_seq: Optional[torch.Tensor] = None,
                 seen_mask: Optional[torch.Tensor] = None,
                 chunk_rows: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k item ids for each query row over a sharded catalog.

    queries    [B, D] on any device (copied to each rank's)
    item_table the P row blocks of `shard_catalog`, equal in size
    num_items  the real catalog size (rows at gid >= num_items are pad)
    seen_seq/seen_mask [B, L]: optional per-user already-seen item ids to
               exclude (the exclude_seen semantics of recommend_top_k)
    chunk_rows 0 = auto (dense per rank up to 131,072 local rows,
               `chunked_topk` streaming past it); -1 = dense; >0 = stream
               each rank's rows in chunks of this many
    recall_target in (0, 1]; the top-k is exact at any value.

    Returns (scores [B, k], item_ids [B, k]) descending, on the mesh's
    first device.
    """
    check_recall_target(recall_target)
    devices = mesh.model_devices
    if len(item_table) != len(devices):
        raise ValueError(f"{len(item_table)} catalog shards for "
                         f"{len(devices)} ranks")
    local = item_table[0].shape[0]
    if not 0 < k <= num_items <= local * len(devices):
        raise ValueError(f"k={k}, num_items={num_items}, "
                         f"{local * len(devices)} catalog rows")
    if chunk_rows == 0:
        chunk_rows = auto_chunk_rows(local)
    vals, ids = [], []
    for p, (tbl, dev) in enumerate(zip(item_table, devices)):
        gid0 = p * local
        real = min(max(num_items - gid0, 0), local)
        if real == 0:
            continue
        k_p = min(k, real)
        q = queries.to(dev)
        seq = None if seen_seq is None else seen_seq.to(dev)
        msk = None if seen_mask is None else seen_mask.to(dev)
        rows = tbl[:real]
        if chunk_rows > 0:
            v, i = chunked_topk(q, rows, real, k_p, chunk_rows=chunk_rows,
                                seen_seq=None if seq is None else seq - gid0,
                                seen_mask=msk)
        else:
            scores = q @ rows.T                               # [B, real]
            if seq is not None:
                seen = scatter_local_mask(seq, gid0, real, valid=msk)
                scores = scores.masked_fill(seen, float("-inf"))
            v, i = torch.topk(scores, k_p, dim=-1)
        # the all-gather: every rank's winners in new buffers on one device
        vals.append(v.to(mesh.device, copy=True))
        ids.append((i + gid0).to(mesh.device, copy=True))
    fv, order = torch.topk(torch.cat(vals, dim=1), k, dim=-1)  # exact merge
    return fv, torch.gather(torch.cat(ids, dim=1), 1, order)


def sharded_recommend_top_k(model, mesh: Mesh, params, final_user,
                            final_item, user_ids: torch.Tensor,
                            seq: torch.Tensor, seq_mask: torch.Tensor,
                            k: int = 10, exclude_seen: bool = True,
                            recall_target: float = 1.0,
                            item_table: Optional[List[torch.Tensor]] = None,
                            chunk_rows: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`SelfGNN.recommend_top_k` over a sharded catalog.

    The query side (the sequence branch and the final_user rows) runs on
    the encode device with the whole `final_item`; only the [B, D]
    queries go to the ranks. Pass `item_table` (pad_catalog +
    shard_catalog) to reuse it across request batches; otherwise it is
    built here from `final_item`."""
    queries = model.serving_queries(params, final_user, final_item,
                                    user_ids, seq, seq_mask)
    num_items = final_item.shape[0]
    if item_table is None:
        item_table = shard_catalog(
            mesh, pad_catalog(final_item, len(mesh.model_devices)))
    return sharded_topk(mesh, queries, item_table, num_items, k,
                        recall_target,
                        seen_seq=seq if exclude_seen else None,
                        seen_mask=seq_mask if exclude_seen else None,
                        chunk_rows=chunk_rows)
