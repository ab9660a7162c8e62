"""Explicitly edge-partitioned SpMM over a mesh's 'model' axis, the
all-gather route and the ring backend's; the port of
`sagnn_tpu/parallel/edge_partition.py`.

The all-gather route (`EdgePartitions`, `partition_edges_by_target`,
`pad_node_table`, byte-equal to JAX's): rank p owns the target rows
[p·rows, (p + 1)·rows) and the edges into them, with global source ids;
a hop all-gathers the source table's row blocks (the table padded to a
multiple of P rows by `pad_node_table`, split by `shard`) and sums the
rank's own target rows. `ag_hop` turns the partitions into the
tensor-parallel hop of `parallel/sharding.py` (`TPHop`): each rank's CSR
plan (pad slots dropped) for the forward, one K1 launch per rank, and the
transpose plan cut by the source rows each rank owns for the backward,
K1 again on the gathered cotangent. `edge_partitioned_spmm` /
`edge_partitioned_propagate` are JAX's functions over the blocks;
`ring_edge_partitioned_spmm` / `_propagate` are the ring's counterparts
over one `RingEdgePartitions` (K6, its backward on that edge set's own
transpose).

Each of the P model ranks owns a row shard of the TARGET nodes and the
edges into it, bucketed by the shard of their SOURCE. One hop is a ring
of P steps: at step s rank p holds the source block of rank
q = (p − s) mod P and adds the sum over bucket (p, q) into its
accumulator, while the block moves on to rank p + 1. Both sides pad to
`rows = round_up(ceil(N / P), 8)` rows per shard, so one hop's output
layout is the next hop's input layout.

Host side (byte-equal to JAX's): `partition_edges_ring`,
`build_interval_ring_partitions`. In place of the
TPU's one-hot chunk plans (`build_ring_bucket_plans`,
`stack_ring_bucket_plans`, `choose_ring_chunk_size`), each bucket is a CSR
plan (`plan_ring_buckets`): row pointers over the shard's targets and the
bucket's source ids, local to the source shard, in target order, with its
weights in that order. `ring_graphs` places every rank's plans on the
rank's device.

Device side: `ring_spmm_apply` is K6, the ring hop with one K6 launch
(`ops.spmm_cuda.ring_bucket_accumulate`) per (rank, step), empty buckets
included; `ring_spmm_apply_plain` is the same ring with the plain bucket
sum (JAX's `ring_spmm_arrays`: the 'mean' path, the CPU and the
references); `ring_spmm` / `RingSpmmFunction` is JAX's custom VJP
`ring_spmm_pallas`, whose backward is the ring over the transpose
direction's plan. Blocks are lists of P tensors, block p on
`mesh.model_devices[p]`; `shard` pads a node table to P·rows rows and
splits it (JAX's `pad_node_table_rows` and P('model') layout), `unshard`
lays the blocks end to end. `exchange` is the ring's one transfer within
a process. With a 'model' axis made of processes
(`scripts/bench_multihost.py`'s ring), `exchange_next` sends the block to
the next process instead and `ring_spmm_apply_procs` runs the same
schedule from one process's rank, its bucket sums K6 launches: the
forward only, as JAX's multi-process ring is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from sagnn_tpu_torch.ops import spmm_cuda as sc
from sagnn_tpu_torch.parallel.mesh import Mesh
from sagnn_tpu_torch.parallel.sharding import TPHop, TPRank, tp_spmm


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# -- host side -------------------------------------------------------------------

@dataclass(frozen=True)
class EdgePartitions:
    """Per-shard edge lists with shard-local target ids (JAX's).

    src: [P, E_shard] int32 global source ids (pad 0)
    tgt_local: [P, E_shard] int32 target id within the shard (pad =
               rows_per_shard), sorted ascending per shard
    rows_per_shard: padded target rows each shard owns
    num_tgt: true global target count
    """

    src: np.ndarray
    tgt_local: np.ndarray
    rows_per_shard: int
    num_tgt: int

    @property
    def num_shards(self) -> int:
        return self.src.shape[0]


def partition_edges_by_target(src: np.ndarray, tgt: np.ndarray,
                              num_tgt: int, num_shards: int,
                              pad_multiple: int = 128) -> EdgePartitions:
    """Split target-sorted edges into `num_shards` row partitions; JAX
    `partition_edges_by_target` (edge_partition.py:60-81), byte for byte.
    Trailing pad edges (tgt == num_tgt) are dropped."""
    src = np.asarray(src, np.int32)
    tgt = np.asarray(tgt, np.int32)
    n = int(np.searchsorted(tgt, num_tgt))
    src, tgt = src[:n], tgt[:n]
    rows = _round_up(-(-num_tgt // num_shards), 8)
    bounds = np.searchsorted(tgt, np.arange(num_shards + 1) * rows)
    counts = np.diff(bounds)
    e_shard = max(pad_multiple,
                  _round_up(int(counts.max(initial=1)), pad_multiple))
    out_src = np.zeros((num_shards, e_shard), np.int32)
    out_tgt = np.full((num_shards, e_shard), rows, np.int32)
    for p in range(num_shards):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        out_src[p, : hi - lo] = src[lo:hi]
        out_tgt[p, : hi - lo] = tgt[lo:hi] - p * rows
    return EdgePartitions(src=out_src, tgt_local=out_tgt,
                          rows_per_shard=rows, num_tgt=num_tgt)


def pad_node_table(x: np.ndarray, num_shards: int) -> np.ndarray:
    """Zero rows after x's so its row count divides by num_shards (JAX
    `pad_node_table`); x itself when it already does."""
    n = x.shape[0]
    target = _round_up(n, num_shards)
    if target == n:
        return x
    return np.concatenate(
        [x, np.zeros((target - n,) + x.shape[1:], x.dtype)])


@dataclass(frozen=True)
class RingEdgePartitions:
    """Edge partitions double-bucketed for the ring schedule (JAX's).

    src_local: [P, P, B] int32, [target shard, source shard, edge]; source
               ids local to their source shard (pad 0)
    tgt_local: [P, P, B] int32, target ids local to the target shard
               (pad = rows_per_shard), sorted ascending per bucket
    rows_per_shard / src_rows_per_shard: padded rows each shard owns
    num_tgt / num_src: true global counts
    weights: optional [P, P, B] f32 per-edge values (pad 0)
    """

    src_local: np.ndarray
    tgt_local: np.ndarray
    rows_per_shard: int
    src_rows_per_shard: int
    num_tgt: int
    num_src: int
    weights: np.ndarray | None = None

    @property
    def num_shards(self) -> int:
        return self.src_local.shape[0]


def partition_edges_ring(src: np.ndarray, tgt: np.ndarray, num_src: int,
                         num_tgt: int, num_shards: int,
                         pad_multiple: int = 128,
                         weights: np.ndarray | None = None
                         ) -> RingEdgePartitions:
    """Bucket target-sorted edges by (target shard, source shard); JAX
    `partition_edges_ring` (edge_partition.py:173-224), byte for byte.
    Trailing pad edges (tgt == num_tgt) are dropped; weights, aligned with
    the input edges, are bucketed alike."""
    src = np.asarray(src, np.int32)
    tgt = np.asarray(tgt, np.int32)
    n = int(np.searchsorted(tgt, num_tgt))
    src, tgt = src[:n], tgt[:n]
    if weights is not None:
        weights = np.asarray(weights, np.float32)[:n]
    P = num_shards
    rows = _round_up(-(-num_tgt // P), 8)
    srows = _round_up(-(-num_src // P), 8)
    tshard = tgt // rows
    sshard = src // srows
    counts = np.zeros((P, P), np.int64)
    np.add.at(counts, (tshard, sshard), 1)
    B = max(pad_multiple,
            _round_up(int(counts.max(initial=1)), pad_multiple))
    out_src = np.zeros((P, P, B), np.int32)
    out_tgt = np.full((P, P, B), rows, np.int32)
    out_w = np.zeros((P, P, B), np.float32) if weights is not None else None
    # bucket-major, target-ascending within a bucket (the edges arrive
    # target-sorted; a stable grouping keeps that order)
    order = np.lexsort((tgt, sshard, tshard))
    s_s, t_s, ts_s, ss_s = src[order], tgt[order], tshard[order], sshard[order]
    w_s = weights[order] if weights is not None else None
    bounds = np.searchsorted(ts_s * P + ss_s, np.arange(P * P + 1))
    for p in range(P):
        for q in range(P):
            lo, hi = int(bounds[p * P + q]), int(bounds[p * P + q + 1])
            out_src[p, q, : hi - lo] = s_s[lo:hi] - q * srows
            out_tgt[p, q, : hi - lo] = t_s[lo:hi] - p * rows
            if w_s is not None:
                out_w[p, q, : hi - lo] = w_s[lo:hi]
    return RingEdgePartitions(src_local=out_src, tgt_local=out_tgt,
                              rows_per_shard=rows, src_rows_per_shard=srows,
                              num_tgt=num_tgt, num_src=num_src,
                              weights=out_w)


def build_interval_ring_partitions(gb, num_shards: int,
                                   pad_multiple: int = 128,
                                   weights: np.ndarray | None = None) -> dict:
    """Ring partitions of every interval graph, both directions, stacked
    [g, P, P, B] with one bucket size per direction; JAX
    `build_interval_ring_partitions` (edge_partition.py:587-651) without
    its TPU chunk plans. gb: `data.graph.IntervalGraphs`; weights:
    optional [2, g, E] from `data.graph.edge_weights`, each direction in
    its own edge order. Returns {"u_src_local", "u_tgt_local",
    "i_src_local", "i_tgt_local", ["u_weights", "i_weights"], "rows_u",
    "rows_i", "num_users", "num_items"}; rows_u / rows_i are the padded
    target rows per shard of each direction and the source rows of the
    other."""
    g = gb.graph_num
    U, I = gb.num_users, gb.num_items
    pu = [partition_edges_ring(
        gb.u_src[k], gb.u_tgt[k], I, U, num_shards, pad_multiple,
        weights=None if weights is None else weights[0, k])
        for k in range(g)]
    pi = [partition_edges_ring(
        gb.i_src[k], gb.i_tgt[k], U, I, num_shards, pad_multiple,
        weights=None if weights is None else weights[1, k])
        for k in range(g)]

    def stack(parts, rows):
        B = max(p.src_local.shape[-1] for p in parts)
        src = np.zeros((g, num_shards, num_shards, B), np.int32)
        tgt = np.full((g, num_shards, num_shards, B), rows, np.int32)
        w = np.zeros((g, num_shards, num_shards, B), np.float32) \
            if weights is not None else None
        for k, p in enumerate(parts):
            b = p.src_local.shape[-1]
            src[k, :, :, :b] = p.src_local
            tgt[k, :, :, :b] = p.tgt_local
            if w is not None:
                w[k, :, :, :b] = p.weights
        return src, tgt, w

    u_src, u_tgt, u_w = stack(pu, pu[0].rows_per_shard)
    i_src, i_tgt, i_w = stack(pi, pi[0].rows_per_shard)
    out = {
        "u_src_local": u_src, "u_tgt_local": u_tgt,
        "i_src_local": i_src, "i_tgt_local": i_tgt,
        "rows_u": pu[0].rows_per_shard, "rows_i": pi[0].rows_per_shard,
        "num_users": U, "num_items": I,
    }
    if weights is not None:
        out["u_weights"] = u_w
        out["i_weights"] = i_w
    return out


def plan_ring_buckets(src_local: np.ndarray, tgt_local: np.ndarray,
                      rows: int, src_rows: int) -> np.ndarray:
    """The CSR row pointers [..., P, P, rows + 1] int32 of every bucket of
    ring partitions [..., P, P, B]: bucket (p, q)'s real edges are
    src_local[p, q, :ptr[-1]], already in target order, and row t's are
    [ptr[t], ptr[t + 1]). Each real source id is checked against the
    source shard here, once, because the kernel does not check it."""
    real = tgt_local < rows
    if (src_local[real] < 0).any() or (src_local[real] >= src_rows).any():
        raise ValueError("a ring bucket's source id is outside its shard")
    flat = tgt_local.reshape(-1, tgt_local.shape[-1])
    ptr = np.stack([sc.csr_row_ptr(t, rows) for t in flat])
    return ptr.reshape(tgt_local.shape[:-1] + (rows + 1,))


@dataclass(frozen=True)
class RingPlan:
    """One direction's bucket plans for every interval, per target rank:
    src[p] [g, P, B] int32 source-shard-local ids, ptr[p] [g, P, rows + 1]
    int32 row pointers and weights[p] [g, P, B] f32 (or None), on the
    device of model rank p; bucket (p, q) of interval k is
    (src[p][k, q], ptr[p][k, q], weights[p][k, q]). rows: target rows per
    shard; src_rows: source rows per shard."""

    src: List[torch.Tensor]
    ptr: List[torch.Tensor]
    weights: Optional[List[torch.Tensor]]
    rows: int
    src_rows: int

    @property
    def num_shards(self) -> int:
        return len(self.src)

    def bucket(self, p: int, k: int, q: int
               ) -> Tuple[torch.Tensor, torch.Tensor,
                          Optional[torch.Tensor]]:
        w = None if self.weights is None else self.weights[p][k, q]
        return self.src[p][k, q], self.ptr[p][k, q], w


def ring_plan(src_local: np.ndarray, tgt_local: np.ndarray, rows: int,
              src_rows: int, mesh: Mesh,
              weights: np.ndarray | None = None) -> RingPlan:
    """The RingPlan of stacked partitions [g, P, P, B], rank p's plans on
    `mesh.model_devices[p]`."""
    P = mesh.shape["model"]
    if src_local.shape[1:3] != (P, P):
        raise ValueError(f"partitions for {src_local.shape[1]} shards, mesh "
                         f"'model' axis {P}")
    ptr = plan_ring_buckets(src_local, tgt_local, rows, src_rows)

    def put(a, p, dev):
        return torch.from_numpy(np.ascontiguousarray(a[:, p])).to(dev)

    devs = mesh.model_devices
    return RingPlan(
        src=[put(src_local, p, d) for p, d in enumerate(devs)],
        ptr=[put(ptr, p, d) for p, d in enumerate(devs)],
        weights=None if weights is None else [
            put(weights, p, d) for p, d in enumerate(devs)],
        rows=rows, src_rows=src_rows)


def ring_graphs(gb, mesh: Mesh, weights: np.ndarray | None = None) -> dict:
    """{"u": RingPlan, "i": RingPlan} of every interval graph in both
    directions (the JAX Trainer's graphs["ring"], trainer.py:234-257), on
    the mesh's first model row: the u-direction's targets are the users,
    its sources the items. weights: [2, g, E] per-edge values
    (`data.graph.edge_weights`), bucketed."""
    return ring_graphs_per_row(gb, mesh.row(0), weights)[0]["ring"]


def ring_graphs_per_row(gb, mesh: Mesh, weights: np.ndarray | None = None
                        ) -> List[dict]:
    """`ring_graphs` of each of the mesh's local data ranks ({"ring": ...}
    graphs dicts, one per row), the partitions built once on the host and
    placed on each row's model devices."""
    P = mesh.shape["model"]
    ring = build_interval_ring_partitions(gb, P, weights=weights)
    out = []
    for d in range(len(mesh.devices)):
        row = {}
        for side, rows, src_rows in (("u", ring["rows_u"], ring["rows_i"]),
                                     ("i", ring["rows_i"], ring["rows_u"])):
            row[side] = ring_plan(ring[f"{side}_src_local"],
                                  ring[f"{side}_tgt_local"], rows, src_rows,
                                  mesh.row(d), ring.get(f"{side}_weights"))
        out.append({"ring": row})
    return out


# -- device side -----------------------------------------------------------------

def exchange(block: torch.Tensor, device: torch.device,
             block_ready: Optional[torch.cuda.Event] = None
             ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """Send one rank's block to the next rank's `device`: a copy into a
    new buffer there, even on the same card, as a ppermute always moves
    data. block_ready: the event after which `block` may be read (the
    previous step's `ready`), or None. Returns (buffer, ready): on a card
    the copy runs on a side stream of the sending card, after the work
    already queued on its current stream and after block_ready, and
    `ready` is an event the receiver's stream must wait on before it
    reads the buffer (JAX's "send early": the transfer overlaps the bucket
    summed meanwhile, edge_partition.py:446-450). `record_stream` keeps
    the block alive until the copy has read it, and the buffer until the
    receiver has. On the CPU, a copy and no event. The ring's only
    transfer; a multi-process ring replaces this."""
    device = torch.device(device)
    if block.device.type != "cuda":
        return block.to(device, copy=True), None
    side = torch.cuda.Stream(device=block.device)     # from torch's pool
    side.wait_stream(torch.cuda.current_stream(block.device))
    if block_ready is not None:
        side.wait_event(block_ready)
    with torch.cuda.stream(side):
        out = block.to(device, copy=True, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(side)
    block.record_stream(side)
    out.record_stream(torch.cuda.current_stream(device))
    return out, ready


def exchange_next(block: torch.Tensor, rank: int, size: int
                  ) -> torch.Tensor:
    """The multi-process form of `exchange`: send this process's block to
    process rank + 1 and receive process rank - 1's (mod size), staged
    through host buffers (`parallel/launch.send_recv`); the received block
    lands on `block`'s device."""
    from sagnn_tpu_torch.parallel.launch import send_recv
    return send_recv(block, (rank + 1) % size, (rank - 1) % size)


def ring_spmm_apply_procs(block: torch.Tensor, src: torch.Tensor,
                          ptr: torch.Tensor, k: int, rank: int, size: int,
                          w: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """One ring hop of interval k over a 'model' axis of `size` processes,
    from process `rank`: out [rows, D] f32, the sum into this rank's
    target shard over every bucket (rank, q). block [src_rows, D]: this
    rank's source block; src [g, P, B], ptr [g, P, rows + 1] (and w [g, P,
    B]): this rank's bucket plans (`plan_ring_buckets` row `rank`), on
    block's device. Per step s the bucket (rank, (rank - s) mod P) is
    summed by one K6 launch (the plain version on the CPU), then the held
    block moves on to the next process; P - 1 exchanges in all."""
    if src.shape[1] != size or ptr.shape[1] != size:
        raise ValueError(f"plans for {src.shape[1]} ranks, {size} "
                         "processes")
    acc = torch.zeros((ptr.shape[-1] - 1, block.shape[1]),
                      dtype=torch.float32, device=block.device)
    held = block
    for s in range(size):
        q = (rank - s) % size
        acc = sc.ring_bucket_accumulate(acc, held, src[k, q], ptr[k, q],
                                        None if w is None else w[k, q])
        if s < size - 1:
            held = exchange_next(held, rank, size)
    return acc


BucketSum = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                      Optional[torch.Tensor]], torch.Tensor]


def _ring(blocks: List[torch.Tensor], plan: RingPlan, k: int, mesh: Mesh,
          bucket_sum: BucketSum) -> List[torch.Tensor]:
    """The ring schedule of JAX's shard_map body (edge_partition.py:
    430-456) for interval k: per step s, first every rank's send, then
    every rank's bucket (p, (p − s) mod P) from the block it holds; P − 1
    exchanging steps and a last local one. bucket_sum(acc, block, src,
    ptr, w) returns acc plus the bucket's sum."""
    devs = mesh.model_devices
    P = plan.num_shards
    if len(devs) != P or len(blocks) != P:
        raise ValueError(f"{len(blocks)} blocks, a plan of {P} shards, mesh "
                         f"'model' axis {len(devs)}")
    for p, (b, dv) in enumerate(zip(blocks, devs)):
        if b.device != dv or b.dim() != 2 or b.shape[0] != plan.src_rows:
            raise ValueError(f"block {p} must be [{plan.src_rows}, D] on "
                             f"{dv}, got {tuple(b.shape)} on {b.device}")
    dtype = torch.float64 if blocks[0].dtype == torch.float64 \
        else torch.float32
    acc = [torch.zeros((plan.rows, blocks[0].shape[1]), dtype=dtype,
                       device=dv) for dv in devs]
    held: list = [(b, None) for b in blocks]
    for s in range(P):
        sent: list = [None] * P
        if s < P - 1:
            for p in range(P):
                sent[(p + 1) % P] = exchange(held[p][0], devs[(p + 1) % P],
                                             held[p][1])
        for p in range(P):
            block, ready = held[p]
            if ready is not None:
                torch.cuda.current_stream(devs[p]).wait_event(ready)
            acc[p] = bucket_sum(acc[p], block, *plan.bucket(p, k, (p - s) % P))
        held = sent
    return acc


def ring_spmm_apply(blocks: List[torch.Tensor], plan: RingPlan, k: int,
                    mesh: Mesh, backward: bool = False
                    ) -> List[torch.Tensor]:
    """One ring hop of interval k through K6: out[p] [rows, D] f32, the
    sum into rank p's target shard over every bucket (p, q), from blocks
    [src_rows, D] (block p on model rank p's device). One K6 launch per
    (rank, step), P·P per hop, weighted when the plan carries weights,
    counted under the "_bwd" names when `backward`. On the CPU each bucket
    runs the plain version. No gradient flows through it: `ring_spmm` is
    the differentiable form."""
    def bucket_sum(acc, block, src, ptr, w):
        return sc.ring_bucket_accumulate(acc, block, src, ptr, w, backward)

    return _ring(blocks, plan, k, mesh, bucket_sum)


def ring_spmm_apply_plain(blocks: List[torch.Tensor], plan: RingPlan, k: int,
                          mesh: Mesh) -> List[torch.Tensor]:
    """The plain version of `ring_spmm_apply`, in the same ring order:
    per bucket, gather + scatter_add_, then acc + partial (in f64 for f64
    blocks). Differentiable by autograd. It is also JAX's
    `ring_spmm_arrays` (edge_partition.py:227-287), the ring that
    direction-dependent weights ('mean') take, whose transpose is not the
    other direction's plan."""
    return _ring(blocks, plan, k, mesh, sc.ring_bucket_accumulate_plain)


class RingSpmmFunction(torch.autograd.Function):
    """A @ x over the ring; JAX `ring_spmm_pallas` and its VJP
    (edge_partition.py:481-511). The backward is the ring over the
    TRANSPOSE direction's plan, whose target shards partition the
    forward's source space: dx = Aᵀ g, K6 again. Exact for unweighted and
    symmetric weights (sym_sqrt) only, where each direction's plan buckets
    the same per-edge values; 'mean' takes `ring_spmm_apply_plain`."""

    @staticmethod
    def forward(ctx, fwd, bwd, k, mesh, *blocks):
        if (bwd.rows, bwd.src_rows) != (fwd.src_rows, fwd.rows):
            raise ValueError(f"the backward plan maps {bwd.src_rows} -> "
                             f"{bwd.rows} rows per shard, the forward "
                             f"{fwd.src_rows} -> {fwd.rows}")
        ctx.args = (bwd, k, mesh)
        return tuple(ring_spmm_apply(list(blocks), fwd, k, mesh))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        bwd, k, mesh = ctx.args
        dx = ring_spmm_apply([g.contiguous() for g in grads], bwd, k, mesh,
                             backward=True)
        return (None,) * 4 + tuple(dx)


def ring_spmm(blocks: List[torch.Tensor], fwd: RingPlan, bwd: RingPlan,
              k: int, mesh: Mesh) -> List[torch.Tensor]:
    """Differentiable ring hop of interval k: fwd is A's plan, bwd Aᵀ's
    (the other direction's plan of the same interval)."""
    return list(RingSpmmFunction.apply(fwd, bwd, k, mesh, *blocks))


def shard(x: torch.Tensor, rows: int, mesh: Mesh) -> List[torch.Tensor]:
    """[N, D] -> the P blocks [rows, D] of x zero-padded to P·rows rows,
    block p on model rank p's device (JAX's P('model', None) layout of the
    padded table)."""
    P = mesh.shape["model"]
    pad = P * rows - x.shape[0]
    if pad < 0:
        raise ValueError(f"{x.shape[0]} rows > {P} x {rows}")
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return [b.to(dv) for b, dv in zip(x.split(rows), mesh.model_devices)]


def unshard(blocks: List[torch.Tensor], n: int,
            device: torch.device) -> torch.Tensor:
    """The first n rows of the blocks laid end to end, on `device`."""
    return torch.cat([b.to(device) for b in blocks])[:n]


# -- the all-gather route and the ring wrappers ----------------------------------

def _check_axis(axis: str) -> None:
    if axis != "model":
        raise ValueError(f"the port's meshes split edges over 'model', not "
                         f"{axis!r}")


def ag_hop(parts: EdgePartitions, mesh: Mesh, src_rows: int,
           exact: bool = True) -> TPHop:
    """The all-gather hop of `parts` as a tensor-parallel hop: rank p's
    plan is its real edges (src[p, :n], CSR pointers over its rows from
    tgt_local) on `mesh.model_devices[p]`; the backward's is the
    transpose of every rank's edges (ids of the gathered targets,
    p·rows + tgt_local, sorted by source), cut by the `src_rows` source
    rows each rank's block holds. exact=False: K1's bf16 table mode.
    ValueError when a source id is outside the P·src_rows gathered rows."""
    devs = mesh.model_devices
    P, rows = parts.num_shards, parts.rows_per_shard
    if len(devs) != P:
        raise ValueError(f"partitions for {P} shards, mesh 'model' axis "
                         f"{len(devs)}")
    fwd, srcs, tgts = [], [], []
    for p, dv in enumerate(devs):
        n = int(np.searchsorted(parts.tgt_local[p], rows))
        src, tl = parts.src[p, :n], parts.tgt_local[p, :n]
        if n and (src.min() < 0 or src.max() >= P * src_rows):
            raise ValueError(f"shard {p} has a source id outside the "
                             f"{P} x {src_rows} gathered rows")
        fwd.append(TPRank(dv, torch.from_numpy(src.copy()).to(dv),
                          torch.from_numpy(sc.csr_row_ptr(tl, rows)).to(dv)))
        srcs.append(src)
        tgts.append(tl + p * rows)
    src, tgt = np.concatenate(srcs), np.concatenate(tgts)
    order = np.lexsort((tgt, src))
    t_src = tgt[order].astype(np.int32)
    t_ptr = sc.csr_row_ptr(src[order], P * src_rows)
    bwd = tuple(TPRank(dv, torch.from_numpy(t_src).to(dv),
                       torch.from_numpy(
                           t_ptr[m * src_rows:(m + 1) * src_rows + 1]).to(dv))
                for m, dv in enumerate(devs))
    return TPHop(tuple(fwd), bwd, exact, folded=False)


def edge_partitioned_spmm(blocks: List[torch.Tensor], parts: EdgePartitions,
                          mesh: Mesh, axis: str = "model",
                          hop: Optional[TPHop] = None) -> List[torch.Tensor]:
    """One all-gather hop, out[t] = Σ_{e: tgt[e]=t} x[src[e]] (JAX
    `edge_partitioned_spmm`): blocks are the P equal row blocks of the
    padded source table (`shard(x, len // P, mesh)` of `pad_node_table`),
    block p on model rank p's device; returns rank p's [rows, D] f32 target
    block, differentiable in the blocks. One K1 launch per rank on the
    card (bf16 table mode for bf16 blocks), the plain version on the CPU.
    hop: `ag_hop(parts, mesh, len(blocks[0]), exact)` built once for
    repeated calls; without it each call builds it on the host."""
    _check_axis(axis)
    if hop is None:
        hop = ag_hop(parts, mesh, blocks[0].shape[0],
                     exact=blocks[0].dtype != torch.bfloat16)
    return tp_spmm(blocks, hop)


def edge_partitioned_propagate(blocks: List[torch.Tensor],
                               parts: EdgePartitions, mesh: Mesh,
                               leaky: float, axis: str = "model",
                               hop: Optional[TPHop] = None) -> torch.Tensor:
    """The hop, sliced to the true target count on the mesh's first device,
    then leaky-relu (JAX `edge_partitioned_propagate`)."""
    out = unshard(edge_partitioned_spmm(blocks, parts, mesh, axis, hop),
                  parts.num_tgt, mesh.device)
    return torch.maximum(leaky * out, out)


def _ring_transpose(parts: RingEdgePartitions) -> RingEdgePartitions:
    """The same edges with source and target swapped (weights alike),
    partitioned over the same P shards: Aᵀ's ring partitions."""
    P = parts.num_shards
    rows, srows = parts.rows_per_shard, parts.src_rows_per_shard
    real = parts.tgt_local < rows
    p_i, q_i, _ = np.nonzero(real)
    src = parts.src_local[real] + q_i * srows
    tgt = parts.tgt_local[real] + p_i * rows
    order = np.lexsort((tgt, src))
    w = None if parts.weights is None else parts.weights[real][order]
    return partition_edges_ring(tgt[order], src[order], parts.num_tgt,
                                parts.num_src, P, weights=w)


def ring_edge_plans(parts: RingEdgePartitions, mesh: Mesh) -> tuple:
    """(forward, backward) ring plans of one `RingEdgePartitions` on
    `mesh`: its own, and those of the same edges (and weights) transposed."""
    def plan(pt, rows, src_rows):
        w = None if pt.weights is None else pt.weights[None]
        return ring_plan(pt.src_local[None], pt.tgt_local[None], rows,
                         src_rows, mesh, w)

    rows, src_rows = parts.rows_per_shard, parts.src_rows_per_shard
    return (plan(parts, rows, src_rows),
            plan(_ring_transpose(parts), src_rows, rows))


def ring_edge_partitioned_spmm(blocks: List[torch.Tensor],
                               parts: RingEdgePartitions, mesh: Mesh,
                               axis: str = "model",
                               plans: Optional[tuple] = None
                               ) -> List[torch.Tensor]:
    """The ring hop of one `RingEdgePartitions` (JAX
    `ring_edge_partitioned_spmm`): blocks [src_rows_per_shard, D], block p
    on model rank p's device (`shard`); returns rank p's [rows, D] f32
    target block, differentiable: K6 forward, K6 on the transpose of the
    same edges (and weights) backward. plans: `ring_edge_plans(parts,
    mesh)` built once for repeated calls; without it each call builds
    them on the host."""
    _check_axis(axis)
    fwd, bwd = plans or ring_edge_plans(parts, mesh)
    return ring_spmm(blocks, fwd, bwd, 0, mesh)


def ring_edge_partitioned_propagate(blocks: List[torch.Tensor],
                                    parts: RingEdgePartitions, mesh: Mesh,
                                    leaky: float, axis: str = "model",
                                    plans: Optional[tuple] = None
                                    ) -> torch.Tensor:
    """The ring hop, sliced to the true target count on the mesh's first
    device, then leaky-relu (JAX `ring_edge_partitioned_propagate`)."""
    out = unshard(ring_edge_partitioned_spmm(blocks, parts, mesh, axis,
                                             plans),
                  parts.num_tgt, mesh.device)
    return torch.maximum(leaky * out, out)
