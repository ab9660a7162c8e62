"""Segment-sum SpMM (unweighted K1, weighted K2, accumulating K3,
row-folded K4, the ring buckets' accumulating modes K6) and SDDMM (K5)
through the hand-written CUDA kernels; the port of
`sagnn_tpu/ops/spmm_pallas.py` (`plan_spmm`, `spmm_apply` with
its slices and folded gathers, `build_stacked_plans`, the source-sharded
`plan_spmm_src_sharded` / `build_stacked_plans_src_sharded` /
`spmm_apply_src_sharded`, the differentiable `spmm`, `spmm_src_sharded`,
`spmm_weighted` and `sddmm`, spmm_pallas.py:362-437, 459-492, 533-686,
689-892, 1062-1112).

The plan is CSR row pointers over the target-sorted COO that
`data.graph.compile_interval_graphs` emits: `ptr = searchsorted(tgt,
arange(num_tgt + 1))`. Pad edges (tgt == num_tgt) sort after
`ptr[num_tgt]` and are never read. This replaces the TPU plan's chunk and
one-hot layout, which existed only to avoid the TPU's scatter. Per-edge
values (weights, scores) lie in the plan's own COO order: slot e belongs
to the edge (src[e], tgt[e]). The TPU's canonical-order indirection
(`edge_slot`/`edge_pos`) is not needed; where a value crosses to the
other direction's plan, it is gathered through the cross-direction
permutation (`data.graph.direction_permutation`).

A source-sharded plan (`build_stacked_plans_src_sharded`) splits each
plan's edges by source shard [s·shard_rows, (s+1)·shard_rows): one flat
array of shard-local source ids, shard after shard, each shard's edges in
target order, and row pointers [S, num_tgt + 1] over all targets per
shard, absolute into that array. Each part is a CSR plan of its own.

Kernels (each on a CUDA tensor launches `csrc/*.cu` or raises; on a CPU
tensor runs its plain PyTorch version, which the tests and
`chip_smoke.py` hold the kernel against):
  * `spmm_apply(x, src, ptr, exact)`: out[t] = Σ_{e in row t} x[src[e]]
    (K1, `csrc/segsum.cu`); with `num_slices > 1` the plan's edges are
    cut into that many contiguous ranges (the row pointers clipped to
    each), and each range's partial sum is added into the output in order
    (K3, the accumulating mode); with `folded=True` and an even row
    count the gathers read the [N/2, 2D] row-folded view (K4).
  * `spmm_apply_src_sharded(x, src, ptr, shard_rows, exact, folded)`:
    the same sum, one K3 launch per source shard in shard order, each on
    the shard's window of x (K3 with K4 when folded and shard_rows is
    even).
  * `spmm_weighted_apply(x, w, src, ptr, exact)`: out[t] = Σ w[e]·x[src[e]]
    (K2, the weighted mode of the same kernel).
  * `sddmm_apply(x, y, src, tgt, ptr, exact)`: s[e] = x[src[e]]·y[tgt[e]]
    for the plan's real edges, 0 on pad slots (K5, `csrc/sddmm.cu`): one
    launch per call in both table modes (bf16 mode rounds f32 tables as
    it reads them), laid out by `sddmm_schedule`.
  * `ring_bucket_accumulate(out, x, src, ptr, w)`: out[t] += Σ w[e]·x[src[e]]
    over one ring bucket's CSR rows (K6, the f32 accumulating modes,
    unweighted or weighted), the launch that
    `parallel/edge_partition.ring_spmm_apply` makes per (rank, ring step).
In every one the sums run in f32; exact=False rounds the gathered tables
to bf16 (as the JAX package does; the segment-sum casts them first, K5
in registers) and keeps weights in f32. Every
segment-sum mode (K1-K4, K6 and the probe P2) is one launch of the same
kernel on an edge-balanced schedule: `segsum_schedule` sizes its grid and
its scratch from num_tgt, len(src) and the SM count, without reading the
plan, and each mode gives the same bits on every launch.

Differentiable forms (`torch.autograd.Function`s whose backwards are the
same kernels; JAX's `jax.custom_vjp`s):
  * `spmm` (`SpmmFunction`): A @ x, dx = Aᵀ g, K1 (K4 when folded) on the
    transpose plan. For a bipartite interval graph the transpose plan is
    the other direction's CSR of the same interval.
  * `spmm_src_sharded` (`SpmmSrcShardedFunction`): A @ x over the
    source-sharded plan; dx is the transpose direction's sharded plan,
    whose shards partition the forward's targets.
  * `spmm_weighted` (`SpmmWeightedFunction`): A_w @ x, differentiable in x
    and w: dx = K2 on the transpose plan with w gathered into its order;
    dw = K5(x, g) over the forward plan, only when w needs a gradient.
  * `sddmm` (`SddmmFunction`): dy = K2 on the forward plan weighted by the
    cotangent ḡ; dx = K2 on the transpose plan weighted by ḡ gathered
    into its order.
The "_bwd" launch counts are the launches these backwards make.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from sagnn_tpu_torch.ops.segment import gather_segment_sum

# Kernel launches per kernel name, incremented only where a launch happens;
# the "_bwd" names count the launches made by the autograd Functions'
# backwards. segsum: K1; segsum_acc: K3; segsum_fold: K4; segsum_fold_acc:
# K3 with K4; wsegsum: K2; sddmm: K5; ring_segsum, ring_wsegsum: K6's
# unweighted and weighted bucket launches (f32 only, as JAX's ring runs
# exact=True only).
LAUNCHES = {f"{kernel}_{mode}{bwd}": 0
            for kernel in ("segsum", "segsum_acc", "segsum_fold",
                           "segsum_fold_acc", "wsegsum", "sddmm")
            for bwd in ("", "_bwd") for mode in ("f32", "bf16")}
LAUNCHES.update({f"{kernel}_f32{bwd}": 0
                 for kernel in ("ring_segsum", "ring_wsegsum")
                 for bwd in ("", "_bwd")})


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def csr_row_ptr(tgt: np.ndarray, num_tgt: int) -> np.ndarray:
    """[num_tgt + 1] int32 row pointers of target-sorted edges `tgt`
    (pad edges, tgt == num_tgt, fall after ptr[num_tgt])."""
    tgt = np.asarray(tgt)
    if tgt.size and (np.diff(tgt) < 0).any():
        raise ValueError("edges must be sorted by target")
    if tgt.size >= 2 ** 31:
        raise ValueError("the kernel indexes edges with int32")
    return np.searchsorted(tgt, np.arange(num_tgt + 1)).astype(np.int32)


def build_stacked_plans(u_src: np.ndarray, u_tgt: np.ndarray,
                        i_src: np.ndarray, i_tgt: np.ndarray,
                        num_users: int, num_items: int) -> dict:
    """CSR row pointers for every interval in both directions, stacked
    [g, ...]: {"u_ptr": [g, U+1], "i_ptr": [g, I+1]}. The source ids stay
    the COO's (`u_src`/`i_src`, already in target order). Each real source
    id is checked against its table size here, once, on the host, because
    the kernel does not check it."""
    def row_ptrs(src, tgt, num_tgt, num_src):
        ptr = np.stack([csr_row_ptr(t, num_tgt) for t in tgt])
        for k in range(src.shape[0]):
            real = src[k, :ptr[k, -1]]
            if real.size and (real.min() < 0 or real.max() >= num_src):
                raise ValueError(f"interval {k}: source id out of range")
        return ptr

    return {"u_ptr": row_ptrs(u_src, u_tgt, num_users, num_items),
            "i_ptr": row_ptrs(i_src, i_tgt, num_items, num_users)}


def num_shards(num_src: int, shard_rows: int) -> int:
    return max(1, -(-num_src // shard_rows))


def plan_src_sharded(src: np.ndarray, tgt: np.ndarray, num_tgt: int,
                     num_src: int, shard_rows: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """One target-sorted COO's source-sharded plan (JAX
    `plan_spmm_src_sharded`, spmm_pallas.py:533-579, in CSR form):
    (src_local [len(src)] int32, ptr [S, num_tgt + 1] int32) with
    S = ceil(num_src / shard_rows). The real edges are reordered shard by
    shard (stable, so each shard's edges stay in target order) and their
    ids made local to the shard; ptr[s] are the row pointers of shard s
    over all targets, absolute into src_local (ptr[s, 0] is where shard s
    starts, ptr[s, -1] where it ends). Pad slots follow, holding 0.

    Not carried from the TPU plan: the chunk padding, `_strip_empty_chunks`
    and the sub-slicing of `_subslice_stacked` (spmm_pallas.py:518-530,
    1022-1059). They bound the TPU's materialised [slots, D] message
    stream; the CUDA kernel gathers each row as it sums and builds no such
    stream. Each real id is checked against the table here, once."""
    src = np.asarray(src)
    tgt = np.asarray(tgt)
    if shard_rows <= 0:
        raise ValueError(f"shard_rows must be > 0, got {shard_rows}")
    n = int(np.searchsorted(tgt, num_tgt))
    real_src, real_tgt = src[:n].astype(np.int64), tgt[:n].astype(np.int64)
    if n and (np.diff(real_tgt) < 0).any():
        raise ValueError("edges must be sorted by target")
    if n and (real_src.min() < 0 or real_src.max() >= num_src):
        raise ValueError("source id out of range")
    if len(src) >= 2 ** 31:
        raise ValueError("the kernel indexes edges with int32")
    S = num_shards(num_src, shard_rows)
    sid = real_src // shard_rows
    # numpy's stable sort is a radix sort for 16-bit keys
    order = np.argsort(sid.astype(np.uint16 if S < 2 ** 16 else np.int64),
                       kind="stable")
    src_local = np.zeros(len(src), np.int32)
    src_local[:n] = real_src[order] - sid[order] * shard_rows
    # edges per (shard, target) in (shard, target) order, which is the
    # order of src_local: their running sum is every shard's row pointers
    counts = np.bincount(sid * num_tgt + real_tgt, minlength=S * num_tgt)
    starts = np.zeros(S * num_tgt + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rows = np.arange(S)[:, None] * num_tgt + np.arange(num_tgt + 1)[None, :]
    return src_local, starts[rows].astype(np.int32)


def build_stacked_plans_src_sharded(u_src: np.ndarray, u_tgt: np.ndarray,
                                    i_src: np.ndarray, i_tgt: np.ndarray,
                                    num_users: int, num_items: int,
                                    shard_rows: int) -> dict:
    """Source-sharded plans for every interval in both directions (JAX
    `build_stacked_plans_src_sharded`, spmm_pallas.py:1062-1112):
    {"u_src": [g, E], "u_ptr": [g, S_u, U + 1], "i_src": [g, E],
    "i_ptr": [g, S_i, I + 1]}, int32, each interval as `plan_src_sharded`
    gives it. shard_rows applies to both source tables: the u-direction
    (user targets) shards the item table, S_u = ceil(I / shard_rows); the
    i-direction the user table."""
    out = {}
    for d, src, tgt, n_tgt, n_src in (("u", u_src, u_tgt, num_users,
                                       num_items),
                                      ("i", i_src, i_tgt, num_items,
                                       num_users)):
        plans = [plan_src_sharded(src[k], tgt[k], n_tgt, n_src, shard_rows)
                 for k in range(src.shape[0])]
        out[f"{d}_src"] = np.stack([p[0] for p in plans])
        out[f"{d}_ptr"] = np.stack([p[1] for p in plans])
    return out


def _plain_table(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """The table a plain version gathers from: bf16-rounded in bf16 mode,
    held in f64 when x is f64 (a reference for the kernels' own f32
    rounding), else in f32."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    return (x if exact else x.to(torch.bfloat16)).to(acc)


def _plan_edges(src: torch.Tensor, ptr: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(source ids, per-edge target ids) of a CSR plan's edges
    src[ptr[0]:ptr[-1]] (ptr[0] is 0 but for a slice or a shard)."""
    counts = (ptr[1:] - ptr[:-1]).long()
    beg, end = int(ptr[0]), int(ptr[-1])
    if src.numel() < end:
        raise ValueError(f"the plan has {end} edges, src {src.numel()}")
    tgt = torch.repeat_interleave(
        torch.arange(ptr.numel() - 1, device=ptr.device), counts)
    return src[beg:end].long(), tgt


def spmm_apply_plain(x: torch.Tensor, src: torch.Tensor, ptr: torch.Tensor,
                     exact: bool = True) -> torch.Tensor:
    """The plain PyTorch version of K1 (and of K4, whose fold changes no
    value): expand the row pointers to per-edge targets, then gather +
    index_add_. bf16 mode sums the bf16-rounded table, as the kernel does.
    The sum runs in f32, or in f64 when x is f64."""
    ids, tgt = _plan_edges(src, ptr)
    return gather_segment_sum(_plain_table(x, exact), ids, tgt,
                              ptr.numel() - 1)


def _accumulate_plain(out: torch.Tensor, x: torch.Tensor, src: torch.Tensor,
                      ptr: torch.Tensor, exact: bool) -> torch.Tensor:
    """The plain version of K3: out[t] += Σ_{e in row t} x[src[e]] (the
    part's gather + scatter_add_ into the accumulator). scatter_add_, not
    index_add_: autograd keeps index_add_'s whole [E, D] source for its
    backward, scatter_add_ only the index (here a stride-0 view), which is
    what lets a training step at the 1M-user scale differentiate through
    this version."""
    ids, tgt = _plan_edges(src, ptr)
    rows = _plain_table(x, exact).index_select(0, ids)
    return out.scatter_add_(0, tgt[:, None].expand_as(rows), rows)


def _accumulator(x: torch.Tensor, num_tgt: int) -> torch.Tensor:
    """Zeros [num_tgt, D] in the dtype the sums run in (f64 for an f64 x,
    else f32)."""
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    return torch.zeros((num_tgt, x.shape[1]), dtype=dtype, device=x.device)


def _slice_ptrs(ptr: torch.Tensor, num_slices: int) -> list[torch.Tensor]:
    """The plan's edges cut into `num_slices` contiguous ranges
    [k·E/n, (k+1)·E/n): each slice's row pointers are ptr clipped to its
    range (its rows outside it become empty), with the same source ids.
    The bounds stay on ptr's device (no copy to the host)."""
    p = ptr.long()
    first, n = p[:1], p[-1:] - p[:1]
    bounds = [first + n * k // num_slices for k in range(num_slices + 1)]
    return [torch.clamp(p, lo, hi).to(torch.int32)
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def spmm_apply_sliced_plain(x: torch.Tensor, src: torch.Tensor,
                            ptr: torch.Tensor, num_slices: int,
                            exact: bool = True) -> torch.Tensor:
    """The plain version of `spmm_apply(num_slices=)`: per slice, gather +
    scatter_add_ into the accumulator."""
    out = _accumulator(x, ptr.numel() - 1)
    for p in _slice_ptrs(ptr, num_slices):
        _accumulate_plain(out, x, src, p, exact)
    return out


def spmm_apply_src_sharded_plain(x: torch.Tensor, src: torch.Tensor,
                                 ptr: torch.Tensor, shard_rows: int,
                                 exact: bool = True) -> torch.Tensor:
    """The plain version of `spmm_apply_src_sharded`: per source shard,
    gather from the shard's window of x + scatter_add_ into the
    accumulator, in shard order."""
    _check_shards(x, ptr, shard_rows)
    out = _accumulator(x, ptr.shape[1] - 1)
    for s in range(ptr.shape[0]):
        _accumulate_plain(out, x[s * shard_rows:(s + 1) * shard_rows], src,
                          ptr[s], exact)
    return out


def _check_shards(x: torch.Tensor, ptr: torch.Tensor,
                  shard_rows: int) -> None:
    if ptr.dim() != 2 or ptr.shape[1] < 1:
        raise ValueError(f"a sharded plan's ptr is [S, num_tgt + 1], got "
                         f"{tuple(ptr.shape)}")
    if shard_rows <= 0 or ptr.shape[0] != num_shards(x.shape[0],
                                                     shard_rows):
        raise ValueError(f"the plan has {ptr.shape[0]} shards, x "
                         f"{x.shape[0]} rows in shards of {shard_rows}")


def spmm_weighted_apply_plain(x: torch.Tensor, w: torch.Tensor,
                              src: torch.Tensor, ptr: torch.Tensor,
                              exact: bool = True) -> torch.Tensor:
    """The plain version of K2: as `spmm_apply_plain`, each gathered row
    scaled by its edge's weight (kept in f32, or f64 with an f64 x)."""
    ids, tgt = _plan_edges(src, ptr)
    table = _plain_table(x, exact)
    beg, end = int(ptr[0]), int(ptr[-1])
    return gather_segment_sum(table, ids, tgt, ptr.numel() - 1,
                              weights=w[beg:end].to(table.dtype))


def sddmm_apply_plain(x: torch.Tensor, y: torch.Tensor, src: torch.Tensor,
                      tgt: torch.Tensor, ptr: torch.Tensor,
                      exact: bool = True) -> torch.Tensor:
    """The plain version of K5: [len(src)] scores x[src[e]]·y[tgt[e]] for
    the plan's ptr[-1] real edges, 0 on the pad slots after them."""
    n_edges = int(ptr[-1])
    if src.numel() < n_edges or tgt.numel() != src.numel():
        raise ValueError(f"the plan has {n_edges} edges, src "
                         f"{src.numel()}, tgt {tgt.numel()}")
    xs = _plain_table(x, exact)[src[:n_edges].long()]
    yt = _plain_table(y, exact)[tgt[:n_edges].long()]
    out = torch.zeros(src.numel(), dtype=xs.dtype, device=xs.device)
    out[:n_edges] = torch.sum(xs * yt, dim=-1)
    return out


def _check_table(name: str, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] % 2 or x.shape[1] == 0:
        raise ValueError(f"{name} must be [N, D] with D even and > 0, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    if x.shape[0] >= 2 ** 31:
        raise ValueError(f"the kernels index {name}'s rows with int32")


def _check_ids(device: torch.device, **ids: torch.Tensor) -> None:
    for name, t in ids.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")


def _check_cuda_args(x: torch.Tensor, src: torch.Tensor,
                     ptr: torch.Tensor) -> None:
    """Raise unless x, src and ptr are what a CUDA launch takes."""
    if x.device.type != "cuda":
        raise ValueError(f"the kernels run on cuda or cpu, not {x.device}")
    _check_table("x", x)
    _check_ids(x.device, src=src, ptr=ptr)
    if ptr.numel() < 1 or ptr.numel() - 1 >= 2 ** 31:
        raise ValueError(f"ptr has {ptr.numel()} entries")
    if src.numel() >= 2 ** 31:
        raise ValueError("the kernels index edges with int32")


def _kernel_table(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """x as the segment-sum kernel reads it: f32, or bf16 in bf16 mode,
    `_aligned`."""
    return _aligned(x.float() if exact else x.to(torch.bfloat16))


def _launch(name: str, device: torch.device, backward: bool,
            *args, count: str | None = None,
            launches: dict | None = None, stream: int | None = None
            ) -> None:
    """Call the library's `sagnn_<name>` with `args`, the device and its
    current stream (or `stream`, a handle of it); raise on a refused
    launch; count it under `count` (default `name`) in `launches` (default
    this module's LAUNCHES)."""
    from sagnn_tpu_torch.ops._build import load_library

    lib = load_library()
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):  # restores the caller's device after
        # the library's cudaSetDevice
        err = getattr(lib, f"sagnn_{name}")(*args, device.index, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.sagnn_error_string(err).decode()}")
    counts = LAUNCHES if launches is None else launches
    counts[(count or name) + ("_bwd" if backward else "")] += 1


def spmm_apply(x: torch.Tensor, src: torch.Tensor, ptr: torch.Tensor,
               exact: bool = True, num_slices: int = 1,
               folded: bool = False, backward: bool = False) -> torch.Tensor:
    """out [num_tgt, D] f32 = Σ over each CSR row of x[src] (K1; see module
    docstring). CUDA: launches the kernel on the current stream without
    synchronising; CPU: the plain version. No gradient flows through it:
    `spmm` is the differentiable form.

    num_slices > 1: the out-of-core path of JAX's `spmm_apply`
    (spmm_pallas.py:411-437), one K3 launch per contiguous edge range in
    order. folded: gather through the [N/2, 2D] row-folded view (K4), as
    JAX does only for an even row count (spmm_pallas.py:392); an odd count
    runs the unfolded mode and counts it under that mode's name. backward:
    count the launch under the "_bwd" name (a hand-written backward, as
    the tensor-parallel hop's, `parallel/sharding.py`).

    `ptr`/`src` must be a plan as `build_stacked_plans` makes and checks
    it: ptr non-decreasing from 0, ptr[-1] <= len(src), every id in
    src[:ptr[-1]] a row of x. The CPU path checks the length; the kernel
    checks none of it (that would cost a read of ptr back to the host on
    every launch) and reads out of bounds on a malformed plan."""
    return _spmm_apply(x, src, ptr, exact, num_slices, folded, backward)


def _spmm_apply(x, src, ptr, exact, num_slices, folded, backward):
    fold = folded and x.shape[0] % 2 == 0
    if num_slices <= 1:
        return _segsum(x, src, ptr, exact, backward, folded=fold)
    if x.device.type == "cpu":
        return spmm_apply_sliced_plain(x, src, ptr, num_slices, exact)
    _check_cuda_args(x, src, ptr)
    table = _kernel_table(x, exact)
    out = _accumulator(x, ptr.numel() - 1)
    for p in _slice_ptrs(ptr, num_slices):
        _launch_segsum(table, src, p, out, exact, backward, accumulate=True,
                       folded=fold)
    return out


def spmm_weighted_apply(x: torch.Tensor, w: torch.Tensor, src: torch.Tensor,
                        ptr: torch.Tensor, exact: bool = True,
                        backward: bool = False) -> torch.Tensor:
    """out [num_tgt, D] f32 = Σ over each CSR row of w[e]·x[src[e]] (K2).
    w: [len(src)] in the plan's edge order, used in f32 in both table
    modes. The plan's contract and `backward` are `spmm_apply`'s;
    `spmm_weighted` is the differentiable form."""
    return _segsum(x, src, ptr, exact, backward=backward, w=w)


def spmm_apply_src_sharded(x: torch.Tensor, src: torch.Tensor,
                           ptr: torch.Tensor, shard_rows: int,
                           exact: bool = True, folded: bool = False,
                           backward: bool = False) -> torch.Tensor:
    """out [num_tgt, D] f32 = Σ over each row of every shard's plan of
    x[shard start + src] (JAX `spmm_apply_src_sharded`,
    spmm_pallas.py:582-640). src, ptr: one interval's sharded plan
    (`plan_src_sharded`): [E] shard-local ids, [S, num_tgt + 1] row
    pointers, S = ceil(len(x) / shard_rows). CUDA: zeros, then one K3
    launch per shard in shard order on the current stream, the table
    pointer moved to the shard's window; with `folded` and an even
    shard_rows (JAX's condition, :612) the launches gather through the
    folded view of the window (K3 with K4). Never K1 over the whole
    table. CPU: the plain version. ptr may be cut by target rows,
    ptr[:, lo:hi + 1] (the tensor-parallel hop, `parallel/sharding.py`):
    each shard's rows keep their absolute pointers into src. backward:
    count the launches under the "_bwd" names, as `spmm_apply`."""
    return _src_sharded(x, src, ptr, shard_rows, exact, folded, backward)


def _src_sharded(x, src, ptr, shard_rows, exact, folded, backward):
    if x.device.type == "cpu":
        return spmm_apply_src_sharded_plain(x, src, ptr, shard_rows, exact)
    _check_shards(x, ptr, shard_rows)
    _check_cuda_args(x, src, ptr[0])
    table = _kernel_table(x, exact)
    out = _accumulator(x, ptr.shape[1] - 1)
    fold = folded and shard_rows % 2 == 0
    for s in range(ptr.shape[0]):
        _launch_segsum(table, src, ptr[s], out, exact, backward,
                       accumulate=True, folded=fold, row0=s * shard_rows)
    return out


def _segsum(x: torch.Tensor, src: torch.Tensor, ptr: torch.Tensor,
            exact: bool, backward: bool, w: torch.Tensor | None = None,
            folded: bool = False) -> torch.Tensor:
    """K1 (K4 when folded) or K2 (w given) into a new output, counting a
    CUDA launch under the forward or the backward name."""
    if x.device.type == "cpu":
        if w is None:
            return spmm_apply_plain(x, src, ptr, exact)
        return spmm_weighted_apply_plain(x, w, src, ptr, exact)
    _check_cuda_args(x, src, ptr)
    if w is not None:
        if w.device != x.device or w.dim() != 1 or w.numel() != src.numel():
            raise ValueError(f"w must be [{src.numel()}] on {x.device}, got "
                             f"{tuple(w.shape)} on {w.device}")
        w = w.float().contiguous()
    out = torch.empty((ptr.numel() - 1, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    _launch_segsum(_kernel_table(x, exact), src, ptr, out, exact, backward,
                   w=w, folded=folded)
    return out


# The segment-sum kernel's schedule (csrc/segsum.cu, which `_build` compiles
# with these numbers): a launch's row ends and edges, T + E items, are cut
# into pieces of PIECE_ITEMS; each warp walks one piece at a time over a
# grid of at most BLOCKS_PER_SM blocks of WARPS_PER_BLOCK warps per SM.
PIECE_ITEMS = 128
WARPS_PER_BLOCK = 8
BLOCKS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class SegsumSchedule:
    pieces: int          # the most pieces (and arrival counters) a launch
    #                      of these sizes can need
    blocks: int          # the grid
    scratch_floats: int  # 2 x D floats per piece: the parts of split rows


def segsum_schedule(num_tgt: int, num_slots: int, d: int,
                    sm_count: int) -> SegsumSchedule:
    """The grid and the scratch of one segment-sum launch, from what the
    host knows without reading the plan: num_tgt rows and num_slots =
    len(src) source slots. The plan's edges E = ptr[-1] - ptr[0] are at
    most num_slots (pad slots and, in a sharded plan, the other shards'
    edges count too), so ceil((num_tgt + num_slots) / PIECE_ITEMS) pieces
    bound the kernel's ceil((num_tgt + E) / PIECE_ITEMS) whatever the
    degrees. The grid fills the card (BLOCKS_PER_SM per SM) or covers every
    piece, whichever is fewer blocks; its size does not change the result."""
    pieces = -(-(num_tgt + num_slots) // PIECE_ITEMS)
    blocks = max(1, min(sm_count * BLOCKS_PER_SM,
                        -(-pieces // WARPS_PER_BLOCK)))
    return SegsumSchedule(pieces=pieces, blocks=blocks,
                          scratch_floats=pieces * 2 * d)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# Per (device, stream handle): the arrival counters of the segment-sum
# kernel and of P1, grown to the largest launch (4 bytes per piece). Each
# kernel leaves every counter at 0, so the zero fill at allocation serves
# every later launch.
# Two launches must never share counters while both run: launches on one
# stream run one after the other, and a handle names one stream for as long
# as the process runs, since PyTorch never destroys the streams it makes
# (the default stream and its pool's). A caller that launches on a stream of
# its own (`torch.cuda.ExternalStream`) must keep it alive until its
# launches end. The scratch is taken per launch from PyTorch's caching
# allocator, which orders its reuse by stream.
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _arrival_counters(device: torch.device, stream: int,
                      pieces: int) -> torch.Tensor:
    """At least `pieces` zeroed arrival counters for launches on `stream`,
    the handle of `device`'s current stream (the segment-sum kernel's, one
    per piece, and P1's, `probes.gather_sum`, the first one)."""
    key = (device.index, stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < pieces:
        counters = torch.zeros(max(1, pieces), dtype=torch.int32,
                               device=device)
        _COUNTERS[key] = counters
    return counters


def _launch_segsum(table: torch.Tensor, src: torch.Tensor, ptr: torch.Tensor,
                   out: torch.Tensor, exact: bool, backward: bool,
                   w: torch.Tensor | None = None, accumulate: bool = False,
                   folded: bool = False, row0: int = 0,
                   count: str | None = None, ablate: bool = False,
                   launches: dict | None = None) -> None:
    """One launch of the segment-sum kernel's mode for (w, accumulate,
    folded, ablate) into `out` [num_tgt, D] f32, reading the table from
    row `row0` on (a shard's window; folded, row0 is even and the window is
    its [rows/2, 2D] view), counted under `count` (default: the mode's
    name) in `launches` (default LAUNCHES). The grid and the scratch come
    from `segsum_schedule`; nothing of ptr or src is read on the host."""
    num_tgt, d = ptr.numel() - 1, table.shape[1]
    if num_tgt == 0:
        return
    _check_ids(table.device, ptr=ptr)
    if ablate:
        kernel = "segsum_ablate"
    elif w is not None:
        kernel = "wsegsum" + ("_acc" if accumulate else "")
    else:
        kernel = ("segsum" + ("_fold" if folded else "")
                  + ("_acc" if accumulate else ""))
    name = f"{kernel}_{'f32' if exact else 'bf16'}"
    device = table.device
    sched = segsum_schedule(num_tgt, src.numel(), d, _sm_count(device.index))
    stream = torch.cuda.current_stream(device).cuda_stream
    scratch = torch.empty(max(1, sched.scratch_floats), dtype=torch.float32,
                          device=device)
    counters = _arrival_counters(device, stream, sched.pieces)
    x = table.data_ptr() + row0 * d * table.element_size()
    args = (src.data_ptr(), ptr.data_ptr(), out.data_ptr(), num_tgt, d,
            scratch.data_ptr(), counters.data_ptr(), sched.blocks)
    if w is not None:
        args = (w.data_ptr(),) + args
    _launch(name, device, backward, x, *args, count=count,
            launches=launches, stream=stream)


def ring_bucket_accumulate(acc: torch.Tensor, x: torch.Tensor,
                           src: torch.Tensor, ptr: torch.Tensor,
                           w: torch.Tensor | None = None,
                           backward: bool = False) -> torch.Tensor:
    """acc [num_tgt, D] plus one ring bucket's sum over each CSR row of
    w[e]·x[src[e]] (w = 1 when None): the bucket's partial is summed from
    zero and added once, the rounding order of JAX's `acc + partial`
    (`sagnn_tpu/parallel/edge_partition.py:444`). x is the source block the
    rank holds, src its block-local ids. CUDA: one K6 launch into acc, in
    place, rows without edges untouched (K3's accumulating entry, or K2's
    and K3's flags together when weighted), counted under K6's names
    `ring_segsum_f32` / `ring_wsegsum_f32`; f32 only, as JAX's ring runs
    exact=True only. CPU: the plain version, which returns a new tensor
    (autograd can differentiate it). The plan's contract is
    `spmm_apply`'s."""
    if x.device.type == "cpu":
        return ring_bucket_accumulate_plain(acc, x, src, ptr, w)
    _check_cuda_args(x, src, ptr)
    if (acc.device != x.device or acc.dtype != torch.float32
            or tuple(acc.shape) != (ptr.numel() - 1, x.shape[1])
            or not acc.is_contiguous()):
        raise ValueError(f"acc must be a contiguous f32 [{ptr.numel() - 1}, "
                         f"{x.shape[1]}] on {x.device}, got {acc.dtype} "
                         f"{tuple(acc.shape)} on {acc.device}")
    if w is not None:
        if w.device != x.device or w.dim() != 1 or w.numel() != src.numel():
            raise ValueError(f"w must be [{src.numel()}] on {x.device}, got "
                             f"{tuple(w.shape)} on {w.device}")
        w = w.float().contiguous()
    name = "ring_segsum_f32" if w is None else "ring_wsegsum_f32"
    _launch_segsum(_kernel_table(x, True), src, ptr, acc, True, backward,
                   w=w, accumulate=True, count=name)
    return acc


def ring_bucket_accumulate_plain(acc: torch.Tensor, x: torch.Tensor,
                                 src: torch.Tensor, ptr: torch.Tensor,
                                 w: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """The plain version of K6: acc + (gather + scatter_add_ over the
    bucket's edges), in f32, or in f64 when x is f64."""
    ids, tgt = _plan_edges(src, ptr)
    table = _plain_table(x, True)
    if w is not None:
        w = w[int(ptr[0]):int(ptr[-1])]
    return acc + gather_segment_sum(table, ids, tgt, ptr.numel() - 1,
                                    weights=w)


# The SDDMM kernel's schedule (csrc/sddmm.cu, which `_build` compiles with
# these numbers): a launch's slots are cut into spans of SDDMM_SPAN, one per
# lane group; a group scores SDDMM_BATCH edges at a time (that many row
# loads of x in flight); blocks of SDDMM_WARPS_PER_BLOCK warps, at most
# SDDMM_BLOCKS_PER_SM per SM (the kernel's launch bound, so that they fit),
# walk the spans with a stride.
SDDMM_SPAN = 64
SDDMM_BATCH = 4
SDDMM_WARPS_PER_BLOCK = 8
SDDMM_BLOCKS_PER_SM = 4
LANE_BYTES = 16          # the widest load a lane makes


@dataclasses.dataclass(frozen=True)
class SddmmSchedule:
    vec: int             # values of a row each lane loads (16 bytes of
    #                      an f32 row where d allows)
    lanes: int           # lanes per row, a power of two <= 32
    rows_per_instruction: int  # 32 // lanes: rows one warp load fetches
    chunks: int          # passes over the columns: ceil(d / (vec * lanes))
    spans: int           # lane groups' spans of SDDMM_SPAN slots
    blocks: int          # the grid


def lane_layout(d: int, elem_bytes: int) -> tuple[int, int, int]:
    """(vec, lanes, chunks) of a row of d values of `elem_bytes` each, for
    tables 16-byte aligned: vec, the most values a lane loads in one load
    of at most LANE_BYTES that divides d (d even: at least 2); lanes, the
    power of two <= 32 that covers d / vec; chunks, the passes that take."""
    vec = next(v for v in (8, 4, 2) if v * elem_bytes <= LANE_BYTES
               and d % v == 0)
    per_row = d // vec
    lanes = min(32, 1 << (per_row - 1).bit_length())
    return vec, lanes, -(-per_row // lanes)


def sddmm_schedule(num_slots: int, d: int, sm_count: int) -> SddmmSchedule:
    """The lane layout and grid of one SDDMM launch over num_slots =
    len(src) slots of d-wide rows. The layout is an f32 row's in both
    modes: the kernel reads f32 tables (bf16 mode rounds them in
    registers). Nothing of the plan is read; the grid's size changes no
    score."""
    if d <= 0 or d % 2:
        raise ValueError(f"d must be even and > 0, got {d}")
    vec, lanes, chunks = lane_layout(d, 4)
    rows = 32 // lanes
    spans = -(-num_slots // SDDMM_SPAN)
    warps = -(-spans // rows)
    blocks = max(1, min(sm_count * SDDMM_BLOCKS_PER_SM,
                        -(-warps // SDDMM_WARPS_PER_BLOCK)))
    return SddmmSchedule(vec=vec, lanes=lanes, rows_per_instruction=rows,
                         chunks=chunks, spans=spans, blocks=blocks)


def sddmm_row_loads(tgt: torch.Tensor, n_edges: int) -> int:
    """The rows of y one K5 pass over the columns loads for a plan whose
    first n_edges slots are its real edges: one per run of equal targets
    within a span of SDDMM_SPAN slots (the first real edge of a span, or
    an edge whose target differs from the edge before it). Host-side, for
    the tests and chip_smoke.py's records; the kernel never calls it."""
    if n_edges <= 0:
        return 0
    t = tgt[:n_edges]
    fresh = torch.ones(n_edges, dtype=torch.bool, device=t.device)
    fresh[1:] = t[1:] != t[:-1]
    fresh[::SDDMM_SPAN] = True
    return int(fresh.sum())


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous with its data LANE_BYTES-aligned (a copy only where
    the view is not), as the kernels' widest lanes read it."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % LANE_BYTES else t


def sddmm_apply(x: torch.Tensor, y: torch.Tensor, src: torch.Tensor,
                tgt: torch.Tensor, ptr: torch.Tensor,
                exact: bool = True, backward: bool = False) -> torch.Tensor:
    """s [len(src)] f32 = x[src[e]]·y[tgt[e]] for the plan's real edges,
    0 on the pad slots (K5). y has one row per target of the plan
    (ptr.numel() - 1); src/tgt are the plan's target-sorted COO. The
    kernel reads the edge count from ptr[-1] on the device and scores
    slots 0, 1, ... of src/tgt: a plan cut by target rows takes its own
    slots (src[e0:e1], tgt[e0:e1] - lo, ptr[lo:hi + 1] - e0). `sddmm` is
    the differentiable form. backward: count the launch under the "_bwd"
    name, as `spmm_apply`."""
    return _sddmm(x, y, src, tgt, ptr, exact, backward)


def _sddmm(x: torch.Tensor, y: torch.Tensor, src: torch.Tensor,
           tgt: torch.Tensor, ptr: torch.Tensor, exact: bool,
           backward: bool) -> torch.Tensor:
    if y.shape[0] != ptr.numel() - 1:
        raise ValueError(f"y has {y.shape[0]} rows, the plan "
                         f"{ptr.numel() - 1} targets")
    if x.device.type == "cpu":
        return sddmm_apply_plain(x, y, src, tgt, ptr, exact)
    _check_cuda_args(x, src, ptr)
    _check_table("y", y)
    _check_ids(x.device, tgt=tgt)
    if y.device != x.device or y.shape[1] != x.shape[1]:
        raise ValueError(f"y {tuple(y.shape)} on {y.device} does not fit x "
                         f"{tuple(x.shape)} on {x.device}")
    if tgt.numel() != src.numel():
        raise ValueError(f"tgt has {tgt.numel()} slots, src {src.numel()}")
    # f32 tables in both modes: bf16 mode rounds them to bf16 as it reads
    # them (no cast kernel); a bf16 table is widened exactly, and rounding
    # it again changes nothing
    xt = _aligned(x.float())
    yt = _aligned(y.float())
    slots, d = src.numel(), x.shape[1]
    out = torch.empty(slots, dtype=torch.float32, device=x.device)
    if slots == 0:
        return out
    sched = sddmm_schedule(slots, d, _sm_count(x.device.index))
    _launch(f"sddmm_{'f32' if exact else 'bf16'}", x.device, backward,
            xt.data_ptr(), yt.data_ptr(), src.data_ptr(), tgt.data_ptr(),
            ptr.data_ptr(), out.data_ptr(), ptr.numel() - 1, slots, d,
            sched.vec, sched.lanes, sched.chunks, sched.blocks)
    return out


class SpmmFunction(torch.autograd.Function):
    """A @ x with dx = Aᵀ g; JAX `spmm`/`_spmm_fwd`/`_spmm_bwd`
    (`sagnn_tpu/ops/spmm_pallas.py:459-492`). The plans get no gradient.
    In bf16 mode the backward casts the cotangent to bf16 before the
    gather, as `_spmm_bwd` does through `spmm_apply(g, ..., exact)`.
    folded: row-folded gathers (K4) both ways, each where its table's row
    count is even."""

    @staticmethod
    def forward(ctx, x, fwd_src, fwd_ptr, bwd_src, bwd_ptr, exact, folded):
        _check_transpose_plan(bwd_ptr.shape[-1] - 1, x)
        ctx.save_for_backward(bwd_src, bwd_ptr)
        ctx.exact, ctx.folded = exact, folded
        return _spmm_apply(x, fwd_src, fwd_ptr, exact, 1, folded,
                           backward=False)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 7
        bwd_src, bwd_ptr = ctx.saved_tensors
        dx = _spmm_apply(g.contiguous(), bwd_src, bwd_ptr, ctx.exact, 1,
                         ctx.folded, backward=True)
        return (dx,) + (None,) * 6


def _check_transpose_plan(num_tgt: int, x: torch.Tensor) -> None:
    if num_tgt != x.shape[0]:
        raise ValueError(f"the backward plan has {num_tgt} targets, x "
                         f"{x.shape[0]} rows")


def spmm(x: torch.Tensor, fwd_src: torch.Tensor, fwd_ptr: torch.Tensor,
         bwd_src: torch.Tensor, bwd_ptr: torch.Tensor,
         exact: bool = True, folded: bool = False) -> torch.Tensor:
    """Differentiable out = A @ x: (fwd_src, fwd_ptr) is A's plan,
    (bwd_src, bwd_ptr) Aᵀ's (the transpose direction's plan of the same
    graph, whose targets are x's rows). Both plans follow `spmm_apply`'s
    contract."""
    return SpmmFunction.apply(x, fwd_src, fwd_ptr, bwd_src, bwd_ptr, exact,
                              folded)


class SpmmSrcShardedFunction(torch.autograd.Function):
    """Source-sharded A @ x; JAX `spmm_src_sharded`/`_spmm_ss_bwd`
    (`sagnn_tpu/ops/spmm_pallas.py:657-686`). The backward is the
    transpose direction's sharded plan: its shards partition the forward's
    targets (g's rows), its targets are x's rows, so dx has exactly
    len(x) rows (JAX slices its padded dx to num_src). Both directions
    launch K3 per shard (with K4 when folded)."""

    @staticmethod
    def forward(ctx, x, fwd_src, fwd_ptr, bwd_src, bwd_ptr, shard_rows,
                exact, folded):
        _check_transpose_plan(bwd_ptr.shape[-1] - 1, x)
        ctx.save_for_backward(bwd_src, bwd_ptr)
        ctx.args = (shard_rows, exact, folded)
        return _src_sharded(x, fwd_src, fwd_ptr, shard_rows, exact, folded,
                            backward=False)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 8
        bwd_src, bwd_ptr = ctx.saved_tensors
        dx = _src_sharded(g.contiguous(), bwd_src, bwd_ptr, *ctx.args,
                          backward=True)
        return (dx,) + (None,) * 7


def spmm_src_sharded(x: torch.Tensor, fwd_src: torch.Tensor,
                     fwd_ptr: torch.Tensor, bwd_src: torch.Tensor,
                     bwd_ptr: torch.Tensor, shard_rows: int,
                     exact: bool = True, folded: bool = False
                     ) -> torch.Tensor:
    """Differentiable source-sharded out = A @ x: (fwd_src, fwd_ptr) is
    A's sharded plan over x's rows, (bwd_src, bwd_ptr) Aᵀ's over A's
    targets, both in shards of `shard_rows` (`plan_src_sharded`)."""
    return SpmmSrcShardedFunction.apply(x, fwd_src, fwd_ptr, bwd_src,
                                        bwd_ptr, shard_rows, exact, folded)


class SpmmWeightedFunction(torch.autograd.Function):
    """A_w @ x, differentiable in x and w; JAX `spmm_weighted` /
    `_spmm_weighted_bwd` (`sagnn_tpu/ops/spmm_pallas.py:797-832`):
      dx = A_wᵀ g: K2 on the transpose plan, w gathered into its order;
      dw[e] = x[src[e]]·g[tgt[e]]: K5 over the forward plan, launched only
      when w needs a gradient (a constant w, as with edge_norm, never
      launches it).
    In bf16 mode both gathered tables (g for dx, x and g for dw) are cast
    to bf16; w stays f32."""

    @staticmethod
    def forward(ctx, x, w, fwd_src, fwd_tgt, fwd_ptr, bwd_src, bwd_ptr,
                to_bwd, exact):
        _check_transpose_plan(bwd_ptr.numel() - 1, x)
        if to_bwd.numel() != w.numel():
            raise ValueError(f"to_bwd has {to_bwd.numel()} slots, w "
                             f"{w.numel()}")
        ctx.save_for_backward(x, w, fwd_src, fwd_tgt, fwd_ptr, bwd_src,
                              bwd_ptr, to_bwd)
        ctx.exact = exact
        return _segsum(x, fwd_src, fwd_ptr, exact, backward=False, w=w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, fwd_src, fwd_tgt, fwd_ptr, bwd_src, bwd_ptr, to_bwd = \
            ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _segsum(g, bwd_src, bwd_ptr, ctx.exact, backward=True,
                         w=w.index_select(0, to_bwd))
        if ctx.needs_input_grad[1]:
            dw = _sddmm(x, g, fwd_src, fwd_tgt, fwd_ptr, ctx.exact,
                        backward=True)
        return (dx, dw) + (None,) * 7


def spmm_weighted(x: torch.Tensor, w: torch.Tensor, fwd_src: torch.Tensor,
                  fwd_tgt: torch.Tensor, fwd_ptr: torch.Tensor,
                  bwd_src: torch.Tensor, bwd_ptr: torch.Tensor,
                  to_bwd: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """Differentiable out = A_w @ x. (fwd_src, fwd_tgt, fwd_ptr): A's plan
    and its COO targets; (bwd_src, bwd_ptr): Aᵀ's plan; w [len(fwd_src)]
    in A's edge order; to_bwd [len(bwd_src)]: for each slot of Aᵀ's plan,
    the slot of the same edge in A's (so w.index_select(0, to_bwd) is w in
    Aᵀ's order)."""
    return SpmmWeightedFunction.apply(x, w, fwd_src, fwd_tgt, fwd_ptr,
                                      bwd_src, bwd_ptr, to_bwd, exact)


class SddmmFunction(torch.autograd.Function):
    """s[e] = x[src[e]]·y[tgt[e]], differentiable in x and y; JAX `sddmm` /
    `_sddmm_bwd` (`sagnn_tpu/ops/spmm_pallas.py:835-869`):
      dy[t] = Σ_{e: tgt=t} ḡ[e]·x[src[e]]: K2 on the forward plan;
      dx[u] = Σ_{e: src=u} ḡ[e]·y[tgt[e]]: K2 on the transpose plan, ḡ
      gathered into its order.
    In bf16 mode the gathered tables (x, y) are cast to bf16; ḡ stays
    f32."""

    @staticmethod
    def forward(ctx, x, y, fwd_src, fwd_tgt, fwd_ptr, bwd_src, bwd_ptr,
                to_bwd, exact):
        _check_transpose_plan(bwd_ptr.numel() - 1, x)
        ctx.save_for_backward(x, y, fwd_src, fwd_ptr, bwd_src, bwd_ptr,
                              to_bwd)
        ctx.exact = exact
        return _sddmm(x, y, fwd_src, fwd_tgt, fwd_ptr, exact, backward=False)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, y, fwd_src, fwd_ptr, bwd_src, bwd_ptr, to_bwd = ctx.saved_tensors
        g = g.contiguous()
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = _segsum(y, bwd_src, bwd_ptr, ctx.exact, backward=True,
                         w=g.index_select(0, to_bwd))
        if ctx.needs_input_grad[1]:
            dy = _segsum(x, fwd_src, fwd_ptr, ctx.exact, backward=True, w=g)
        return (dx, dy) + (None,) * 7


def sddmm(x: torch.Tensor, y: torch.Tensor, fwd_src: torch.Tensor,
          fwd_tgt: torch.Tensor, fwd_ptr: torch.Tensor,
          bwd_src: torch.Tensor, bwd_ptr: torch.Tensor, to_bwd: torch.Tensor,
          exact: bool = True) -> torch.Tensor:
    """Differentiable edge scores [len(fwd_src)] in A's edge order (pad
    slots 0); the arguments as `spmm_weighted`'s, y with one row per
    target of A."""
    return SddmmFunction.apply(x, y, fwd_src, fwd_tgt, fwd_ptr, bwd_src,
                               bwd_ptr, to_bwd, exact)
