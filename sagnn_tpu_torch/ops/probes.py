"""The measurement probes P1 (row gather) and P2 (ablated segment-sum) on
the card; the port of `scripts/probe_dma_gather.py` and
`scripts/probe_overhead.py`.

    python -m sagnn_tpu_torch.ops.probes [--flagship] [--seed N]

prints one JSON line (rows/s and GB/s of P1 per dtype, run and loads in
flight; the library gather's rows/s; the run and tile factors of the
port's CSR plans; per hop of interval 0, the times of P1 on the hop's
edge stream, P2 and K1). It needs a card: the probes measure it.

Kernels (each on a CUDA tensor launches its kernel or raises; on a CPU
tensor runs its plain version, which the tests and `chip_smoke.py` hold
the kernel against):
  * `gather_sum(x, src, run, in_flight)` (P1, `csrc/probes.cu`): the f32
    sum of the rows src[i] + r, r < run, of an [N, D] f32 or bf16 table,
    with `in_flight` independent load instructions per lane, each of 16
    bytes where D allows (the x gather of K5, `csrc/sddmm.cu`), in one
    launch (`gather_schedule` sizes its chunks, grid and scratch). JAX's
    `dma_kernel` (probe_dma_gather.py:100-134) fetched the same rows by
    async DMA.
  * `segsum_ablate(x, src, ptr, exact)` (P2, the `kAblate` mode of
    `csrc/segsum.cu`): K1's walk and row loads without its adds; each row
    gives its last source's row, out[t] = x[src[ptr[t+1] - 1]], zeros for
    an empty row. JAX's `ablate_kernel` (probe_overhead.py:94-104) kept the
    segment-sum's grid and replaced its one-hot dot by a column sum.

What they split: P1 on a hop's own edge stream is its row loads alone,
spread over the whole card; P2 adds K1's walk (its schedule: each warp
searches, stages and walks one piece of row ends and edges at a time);
K1 adds the adds and the combine of rows split between pieces. So (P1,
P2 - P1, K1 - P2) is K1's time split between the loads, the walk and the
adds.

Host factors (`plan_factors`, the counterparts of
probe_dma_gather.py:57-67, 219-237), over the port's CSR plans: a stream
is one target row's sources cut into GROUP-edge groups (the streams of
JAX's probe; the fetches of neighbouring ids that a gather can merge).
The run factor is edges per run of consecutive-or-equal ids in a stream;
the tile factor for w is edges per distinct aligned w-row window in a
stream.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from sagnn_tpu_torch.ops import spmm_cuda as sc
from sagnn_tpu_torch.utils import profiling

# kernel launches per probe, incremented only where a launch happens
LAUNCHES = {f"{kernel}_{mode}": 0 for kernel in ("gather_sum",
                                                 "segsum_ablate")
            for mode in ("f32", "bf16")}
RUNS = (1, 4, 8, 16)         # consecutive rows per id (P1's tile gather)
IN_FLIGHT = (1, 2, 4, 8)     # independent row loads per warp (P1)
SPLIT_IN_FLIGHT = 8          # P1 on a hop's stream: K1's unroll
# P1's schedule (csrc/probes.cu, which `_build` compiles with these
# numbers): the rows (ids x run) are cut into chunks of P1_CHUNK_ROWS, each
# summed by one block of P1_WARPS_PER_BLOCK warps into one partial row; at
# most P1_BLOCKS_PER_SM blocks per SM walk the chunks with a stride
P1_CHUNK_ROWS = 2048
P1_WARPS_PER_BLOCK = 8
P1_BLOCKS_PER_SM = 8
GROUP = 32                   # edges per stream of the host factors
TILE_WIDTHS = (16, 32, 64)
# the probe's own shape (probe_dma_gather.py:166-186): 1,048,576 rows of 64
# (256 MB in f32, five times the L2), 1,048,576 rows fetched, ids sorted
# within each chunk of 1,024 fetched rows; and a gowalla-size table
# (49,152 rows, 12.6 MB in f32) that L2 holds
PROBE_ROWS = 1 << 20
PROBE_FETCHED = 1 << 20
PROBE_CHUNK = 1024
L2_ROWS = 49_152
D = 64


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- P1: the row gather -------------------------------------------------------

def _run_rows(src: torch.Tensor, run: int) -> torch.Tensor:
    """The row ids that ids `src` with `run` rows each cover, in order."""
    src = src.long()
    if run == 1:
        return src
    return (src[:, None] + torch.arange(run, device=src.device)).reshape(-1)


def gather_sum_plain(x: torch.Tensor, src: torch.Tensor,
                     run: int = 1) -> torch.Tensor:
    """P1's plain version: [D] = Σ of the rows src[i] + r, r < run, summed
    in f32 (in f64 when x is f64). For run 1 it is the library call
    `x.index_select(0, src).float().sum(0)`."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    return x.index_select(0, _run_rows(src, run)).to(acc).sum(0)


@dataclasses.dataclass(frozen=True)
class GatherSchedule:
    vec: int             # values of a row each lane loads (<= 16 bytes)
    lanes: int           # lanes per row, a power of two
    rows_per_instruction: int  # 32 // lanes
    chunks: int          # partial rows: ceil(n_ids * run / P1_CHUNK_ROWS)
    blocks: int          # the grid
    scratch_floats: int  # chunks x d (at least 1)


def gather_schedule(n_ids: int, run: int, d: int, sm_count: int,
                    elem_bytes: int = 4) -> GatherSchedule:
    """P1's lane layout (`spmm_cuda.lane_layout`, one pass: d <= 64), its
    chunks, grid and scratch for n_ids ids of `run` rows. The chunks, and so
    the order of every sum, depend on n_ids and run alone; the grid only
    spreads them (at most P1_BLOCKS_PER_SM blocks per SM)."""
    if d % 2 or not 0 < d <= D:
        raise ValueError(f"P1 takes an even d <= {D}, got {d}")
    vec, lanes, _ = sc.lane_layout(d, elem_bytes)
    chunks = -(-n_ids * run // P1_CHUNK_ROWS)
    return GatherSchedule(
        vec=vec, lanes=lanes, rows_per_instruction=32 // lanes,
        chunks=chunks, blocks=max(1, min(chunks, sm_count * P1_BLOCKS_PER_SM)),
        scratch_floats=max(1, chunks * d))


def gather_sum(x: torch.Tensor, src: torch.Tensor, run: int = 1,
               in_flight: int = SPLIT_IN_FLIGHT) -> torch.Tensor:
    """[D] f32 = Σ over ids i and r < run of x[src[i] + r] (P1). CUDA: x
    [N, D] f32 or bf16 (D even, at most 64), src int32 with every
    src[i] + run - 1 a row of x (not checked: the kernel trusts it), run
    in RUNS, in_flight in IN_FLIGHT (load instructions in flight per lane,
    each fetching `rows_per_instruction` rows); one launch on the current
    stream (the gather, and the sum of its chunks' partial rows by the
    last block to finish), no sync. CPU: the plain version."""
    if run not in RUNS or in_flight not in IN_FLIGHT:
        raise ValueError(f"run {run} not in {RUNS} or in_flight "
                         f"{in_flight} not in {IN_FLIGHT}")
    if x.device.type == "cpu":
        return gather_sum_plain(x, src, run)
    if x.device.type != "cuda":
        raise ValueError(f"the probes run on cuda or cpu, not {x.device}")
    if x.dim() != 2 or x.shape[1] % 2 or not 0 < x.shape[1] <= 64:
        raise ValueError(f"x must be [N, D] with D even and <= 64, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    sc._check_ids(x.device, src=src)
    table = sc._aligned(x)
    d = table.shape[1]
    sched = gather_schedule(src.numel(), run, d, sc._sm_count(x.device.index),
                            table.element_size())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    scratch = torch.empty(sched.scratch_floats, dtype=torch.float32,
                          device=x.device)
    counter = sc._arrival_counters(x.device, stream, 1)
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    mode = "f32" if x.dtype == torch.float32 else "bf16"
    sc._launch(f"gather_sum_{mode}", x.device, False, table.data_ptr(),
               src.data_ptr(), src.numel(), run, in_flight, sched.vec,
               sched.lanes, scratch.data_ptr(), counter.data_ptr(),
               sched.blocks, out.data_ptr(), d, launches=LAUNCHES,
               stream=stream)
    return out


def probe_ids(n_rows: int, fetched: int, run: int, chunk: int = PROBE_CHUNK,
              seed: int = 0) -> np.ndarray:
    """[fetched // run] int32 run starts, aligned to `run`, uniform over
    the table, ascending within each chunk of `chunk // run` ids (the plan
    sorts sources within a block, probe_dma_gather.py:166-186)."""
    rng = np.random.default_rng(seed)
    per_chunk = max(1, chunk // run)
    n_ids = fetched // run
    starts = rng.integers(0, n_rows // run, n_ids, dtype=np.int64) * run
    n_full = n_ids // per_chunk * per_chunk
    starts[:n_full] = np.sort(starts[:n_full].reshape(-1, per_chunk), axis=1
                              ).reshape(-1)
    return starts.astype(np.int32)


# -- P2: the ablated segment-sum ----------------------------------------------

def segsum_ablate_plain(x: torch.Tensor, src: torch.Tensor,
                        ptr: torch.Tensor, exact: bool = True
                        ) -> torch.Tensor:
    """P2's plain version: out[t] = x[src[ptr[t+1] - 1]] for each row with
    edges, zeros for the others, on the table as the kernel reads it
    (bf16-rounded in bf16 mode), in f32."""
    if src.numel() < int(ptr[-1]):
        raise ValueError(f"the plan has {int(ptr[-1])} edges, src "
                         f"{src.numel()}")
    table = sc._plain_table(x, exact).float()
    beg, end = ptr[:-1].long(), ptr[1:].long()
    rows = end > beg
    out = torch.zeros((ptr.numel() - 1, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    out[rows] = table[src.long()[end[rows] - 1]]
    return out


def segsum_ablate(x: torch.Tensor, src: torch.Tensor, ptr: torch.Tensor,
                  exact: bool = True) -> torch.Tensor:
    """out [num_tgt, D] f32 (P2): K1's walk and loads of every edge's row
    with no adds; out[t] = x[src[ptr[t+1] - 1]], zeros for an empty row.
    The plan's contract is `spmm_apply`'s. CUDA: one launch on the current
    stream, no sync; CPU: the plain version."""
    if x.device.type == "cpu":
        return segsum_ablate_plain(x, src, ptr, exact)
    sc._check_cuda_args(x, src, ptr)
    out = torch.empty((ptr.numel() - 1, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    sc._launch_segsum(sc._kernel_table(x, exact), src, ptr, out, exact,
                      False, ablate=True, launches=LAUNCHES)
    return out


# -- host factors of the CSR plans --------------------------------------------

def run_coalescing_factor(streams) -> float:
    """Mean edges per run of consecutive-or-equal source ids over
    `streams` (probe_dma_gather.py:57-67; a run is one contiguous fetch)."""
    total_edges = 0
    total_runs = 0
    for chunk in streams:
        d = np.diff(chunk)
        runs = 1 + int(((d != 0) & (d != 1)).sum())
        total_edges += len(chunk)
        total_runs += runs
    return total_edges / max(total_runs, 1)


def plan_factors(src: np.ndarray, ptr: np.ndarray,
                 group: int = GROUP) -> dict:
    """The run factor and the tile factors for TILE_WIDTHS of a CSR plan's
    streams (each row's sources cut into `group`-edge groups, in plan
    order; empty rows give none), computed over all its edges at once."""
    src, ptr = np.asarray(src), np.asarray(ptr).astype(np.int64)
    n = int(ptr[-1])
    ids = src[:n].astype(np.int64)
    deg = np.diff(ptr)
    row = np.repeat(np.arange(len(deg)), deg)
    pos = np.arange(n) - ptr[:-1][row]
    gid = np.cumsum(pos % group == 0) - 1          # the edge's stream
    groups = int(gid[-1]) + 1 if n else 0
    d = np.diff(ids)
    breaks = int((((d != 0) & (d != 1)) & (gid[1:] == gid[:-1])).sum())
    out = {"edges": n, "streams": groups,
           "run": n / max(groups + breaks, 1)}
    span = int(ids.max()) + 1 if n else 1
    for w in TILE_WIDTHS:
        windows = np.unique(gid * (span // w + 1) + ids // w).size
        out[f"tile{w}"] = n / max(windows, 1)
    return out


def bench_fill_plan(num_src: int = 40_960, num_tgt: int = 40_960,
                    edges: int = 4_000_000, seed: int = 0
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(src, ptr) of a uniform random graph at bench.py's fill (40,960 x
    40,960, 4M edges), target-sorted with each row's sources ascending,
    as the port's plans come from a sparse matrix."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_src, edges)
    tgt = rng.integers(0, num_tgt, edges)
    order = np.lexsort((src, tgt))
    return (src[order].astype(np.int32),
            sc.csr_row_ptr(tgt[order], num_tgt))


# -- measurements on the card -------------------------------------------------

def gather_sweep(n_rows: int, device, seed: int = 0,
                 iters: int = 10) -> dict:
    """P1 over a random [n_rows, 64] table, f32 and bf16, every run and
    in-flight count, PROBE_FETCHED rows fetched per call: ms, rows/s and
    GB/s (gathered bytes over time); the library gather (index_select +
    sum, at run 1) beside. Tables larger than L2 measure HBM gathers."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x32 = torch.randn((n_rows, D), generator=gen, device=device)
    out = {"rows": n_rows, "fetched": PROBE_FETCHED,
           "table_mb": n_rows * D * 4 / 1e6}
    for x in (x32, x32.to(torch.bfloat16)):
        mode = "f32" if x.dtype == torch.float32 else "bf16"
        for run in RUNS:
            src = torch.from_numpy(probe_ids(n_rows, PROBE_FETCHED, run,
                                             seed=seed)).to(device)
            rows = src.numel() * run
            for k in IN_FLIGHT:
                ms = profiling.device_ms(lambda: gather_sum(x, src, run, k),
                                         iters=iters)
                out[f"{mode}_run{run}_in_flight{k}"] = {
                    "ms": ms, "rows_per_s": rows / ms * 1e3,
                    "GB_per_s": rows * D * x.element_size() / ms / 1e6}
            if run == 1:
                ms = profiling.device_ms(lambda: gather_sum_plain(x, src),
                                         iters=iters)
                out[f"{mode}_library"] = {
                    "ms": ms, "rows_per_s": rows / ms * 1e3,
                    "GB_per_s": rows * D * x.element_size() / ms / 1e6,
                    "call": "x.index_select(0, src).float().sum(0)"}
    del x32
    return out


def hop_split(x: torch.Tensor, src: torch.Tensor, ptr: torch.Tensor,
              exact: bool = True, iters: int = 10) -> dict:
    """One hop's split of K1's time: P1 on the hop's edge stream (p1_ms,
    the loads alone, edge-parallel, SPLIT_IN_FLIGHT in flight), P2 (K1's
    walk and loads, no adds) and K1, in ms of device time
    (`profiling.device_ms`: the host's cost of the calls taken out), so
    walk = P2 - P1 and adds = K1 - P2; the longest row's ns per edge under
    P2 and K1."""
    n = int(ptr[-1])
    stream = src[:n]
    table = sc._kernel_table(x, exact)
    max_deg = int((ptr[1:] - ptr[:-1]).max()) if ptr.numel() > 1 else 0
    p1 = profiling.device_ms(
        lambda: gather_sum(table, stream, 1, SPLIT_IN_FLIGHT), iters)
    p2 = profiling.device_ms(lambda: segsum_ablate(x, src, ptr, exact),
                             iters)
    k1 = profiling.device_ms(lambda: sc.spmm_apply(x, src, ptr, exact),
                             iters)
    return {"edges": n, "max_degree": max_deg, "p1_ms": p1, "p2_ms": p2,
            "k1_ms": k1, "walk_ms": p2 - p1, "adds_ms": k1 - p2,
            "p2_ns_per_edge_longest": p2 * 1e6 / max(1, max_deg),
            "k1_ns_per_edge_longest": k1 * 1e6 / max(1, max_deg)}


def split(graphs: dict, device, seed: int = 0, iters: int = 10) -> dict:
    """`hop_split` on interval 0's u-hop (item table) and i-hop (user
    table) of `graphs` (`graphs_to_device`'s keys), on random f32 tables
    and their bf16 copies, and each pair's sums."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tables = {}
    for d, o in (("u", "i"), ("i", "u")):
        n_src = graphs[f"{o}_ptr"].shape[-1] - 1
        tables[d] = torch.randn((n_src, D), generator=gen, device=device)
    out = {}
    for exact, mode in ((True, "f32"), (False, "bf16")):
        hops = {d: hop_split(tables[d], graphs[f"{d}_src"][0],
                             graphs[f"{d}_ptr"][0], exact, iters)
                for d in ("u", "i")}
        hops["pair"] = {k: hops["u"][k] + hops["i"][k]
                        for k in ("p1_ms", "p2_ms", "k1_ms", "walk_ms",
                                  "adds_ms")}
        out[mode] = hops
    return out


def factors(gowalla_graphs: dict | None = None) -> dict:
    """`plan_factors` at bench.py's fill and, given the gowalla bundle's
    graphs, on interval 0's two plans."""
    out = {"bench_fill": plan_factors(*bench_fill_plan())}
    if gowalla_graphs is not None:
        for d in ("u", "i"):
            out[f"gowalla_{d}"] = plan_factors(
                gowalla_graphs[f"{d}_src"][0].cpu().numpy(),
                gowalla_graphs[f"{d}_ptr"][0].cpu().numpy())
    return out


def run(device, gowalla_graphs: dict | None = None,
        flagship_graphs: dict | None = None, seed: int = 0) -> dict:
    """Every probe measurement: P1's sweep on the probe's HBM-size table
    and on an L2-size one, the plan factors, and the split of K1 on the
    given graphs' interval 0 (f32 and bf16 tables). The CLI's output."""
    out = {"p1": {"hbm": gather_sweep(PROBE_ROWS, device, seed),
                  "l2": gather_sweep(L2_ROWS, device, seed)},
           "factors": factors(gowalla_graphs), "split": {}}
    for name, graphs in (("gowalla", gowalla_graphs),
                         ("flagship", flagship_graphs)):
        if graphs is not None:
            out["split"][name] = split(graphs, device, seed=seed)
    return out


def _gowalla_graphs(device) -> dict:
    """The graphs of chip_smoke.py's gowalla-scale synthetic bundle."""
    from sagnn_tpu_torch.data.graph import compile_interval_graphs
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.models.selfgnn import graphs_to_device

    bundle = synthetic_dataset(num_users=49_152, num_items=40_960,
                               graph_num=3, test_size=1000, seed=7,
                               seq_len_range=(10, 50))
    return graphs_to_device(compile_interval_graphs(bundle.sub_mats), device)


def _flagship_graphs(device) -> dict:
    """Interval 0's plans of the 1M-user flagship bundle
    (scripts/bench_1m.py:35-48)."""
    from sagnn_tpu_torch.data.graph import compile_interval_graphs
    from sagnn_tpu_torch.data.synthetic import synthetic_large_dataset
    from sagnn_tpu_torch.models.selfgnn import graphs_to_device

    bundle = synthetic_large_dataset(num_users=1_048_576, num_items=786_432,
                                     total_edges=60_000_000, graph_num=3,
                                     test_size=100, seed=0)
    return graphs_to_device(compile_interval_graphs(bundle.sub_mats), device)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="P1 and P2 on the card")
    p.add_argument("--flagship", action="store_true",
                   help="also split K1 on the 1M-user flagship's interval 0 "
                        "(builds its bundle: about a minute of host work)")
    p.add_argument("--seed", type=int, default=0)
    ns = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("the probes measure a CUDA card; none is available")
    device = torch.device("cuda", 0)
    out = run(device, _gowalla_graphs(device),
              _flagship_graphs(device) if ns.flagship else None, ns.seed)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
