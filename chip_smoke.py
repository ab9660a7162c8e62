#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA card
and check them.

    python3 chip_smoke.py

Phases, in this order: 1-5, 8, 9, 6, 10, 15, 16, 18, 7, 11, 19, 21, 13,
12, 17, 20, 14
(any failure raises and the script exits non-zero; it prints no result
line then):
  1. device  — require CUDA; print the card's name and power limit.
  2. build   — compile sagnn_tpu_torch/csrc/*.cu (segsum.cu, sddmm.cu,
               probes.cu), one nvcc per source in parallel (timed).
  3. set-up  — the synthetic gowalla-scale bundle (49,152 users x 40,960
               items, 3 intervals, sequences of 10-50 items), its graphs
               and CSR plans, and seeded random weights (timed).
  4. kernels — the segment-sum kernel (f32 and bf16 tables) on interval 0
               in both directions, an empty graph and a graph with empty
               rows, each held against its plain PyTorch version; then its
               backward (`SpmmFunction`, the kernel on the transpose plan)
               against the plain transpose sum; kernel, plain and library
               (torch.sparse.mm) times with CUDA events.
  5. serving — the gowalla preset at full width (latdim 64, 16 heads,
               g=3, gnn_layer 2, att_layer 1, pos_length 200, 1000
               candidates) through `Recommender`: encode through the
               kernel (launch counts read just after), held against the
               plain backend (its propagation summed in f64), top-10 for
               256 users, HR/NDCG over up to 4,096 test users; then the
               bf16-table encode as a second path, held hop by hop
               against the plain version on the inputs it gave each hop;
               the encode with spmm_fold_gather on both tables (12
               row-folded K4 launches, K1's node states bit for bit).
  6. train step check — one full-width training step (keep_rate 1,
               batch 512) on the kernel path against the plain backend with
               its propagation summed in f64: preLoss, sslloss and every
               parameter's gradient; 12 forward and 12 backward launches;
               the same step on the bf16 table (12 + 12 of its launches);
               both steps with spmm_fold_gather (K4, 12 + 12); at keepRate
               0.5, the step with remat_propagation and fusion_chunk_rows
               16,384 (24 + 12 launches) against the step without them
               from one dropout-generator state; the device time of the
               step and of its parts. The fold steps are held against the
               unfolded ones with PyTorch's deterministic algorithms on
               (without them the bf16 step itself varies from run to run,
               logged).
  7. training — `Trainer(...).run()` with the unchanged gowalla preset
               (keepRate 0.5) and the native sampler (built by g++ from
               sagnn_tpu_torch/native/sampler.cc; a failed build fails) for
               one epoch of ceil(trn_num / batch) = 20 steps, its
               evaluation over every test user and its best-NDCG
               checkpoint; a timed evaluation, a full-sort evaluation of
               every test user (dense over 40,960 items) and a save; a
               second `Trainer` restoring the checkpoint (epoch, step,
               params); one more step on each from the same batch and
               dropout state, held against each other; a torch.profiler
               pass over 3 steps on that batch (device busy share, top
               kernels); host ms per batch with the native and the numpy
               sampler, and an epoch with the numpy one.
  8. variant serving — the preset with edge_norm="sym_sqrt", "mean" (12 K2,
               no K1) and edge_attention (12 K5 + 12 K2), on the same bundle
               and weights, each encode held against the plain path with
               its propagation (and softmax) in f64; a bf16 attention encode
               held hop by hop.
  9. edge kernels — K2 and K5 (f32 and bf16) on interval 0, both
               directions, an empty graph and a graph with empty rows,
               against their plain versions in f64; both backwards
               (`SpmmWeightedFunction` dx and dw, `SddmmFunction` dx and dy)
               against plain autograd in f64; kernel, plain, library
               (torch.sparse.mm, torch.sparse.sampled_addmm) and bound.
               Each K5 record holds the CUDA kernels one call makes
               (torch.profiler); its `schedule` log line gives the lane
               layout the host chose (values and bytes per lane, rows per
               warp load) and the plan's runs of equal targets per span,
               the y rows the schedule loads: modelled, not measured.
 10. variant steps — one step each with edge_norm="mean", edge attention,
               edge_dropout_keep=0.8 (one mask from one generator state on
               both sides) against the plain path in f64, each hop's
               leaky-relu on the kernel path's side of the kink; and edge
               attention on bf16 tables against the f32 step.
 11. variant training — `Trainer.run()` for one epoch with edge attention
               and its evaluations; an epoch with edge_norm="sym_sqrt" and
               edge_dropout_keep=0.8, checkpointed, resumed, and one more
               step on each held against the other.
 12. flagship — the 1M-user flagship of scripts/bench_1m.py: its bundle
               (1,048,576 users x 786,432 items x 60M drawn edges, g=3,
               `synthetic_large_dataset`, seed 0) and the exact_b512
               recipe (latdim 64, 8 heads, ssldim 48, batch 512, sampNum
               10, sslNum 8, remat_propagation, fusion_chunk_rows 16,384,
               spmm_fold_gather; spmm_src_shard_rows auto). A `Trainer`
               (shard rows resolved to 131,072, sharded plans attached)
               and a `Recommender` with the fold off on the same weights;
               K3, K4 and K3 with K4 on interval 0 (f32 and bf16 tables,
               forward and backward) against their plain versions in f64,
               with K1 and torch.sparse.mm on the same hops; the encode
               (84 K3 launches) against the plain backend's propagation in
               f64, a top-10 for 256 users, an evaluation of 4,096 test
               users; a bf16-table encode held hop by hop; one full-width
               step at keepRate 1 against the plain path in f64 (168 + 84
               folded K3 launches: forward, recompute, backward), the same
               step with the fold off and on bf16 tables; four
               `Trainer.train_step`s at keepRate 0.5, timed, with the peak
               device memory; a torch.profiler pass over two more; the
               Trainer's full-sort evaluation of its 4,096 test users,
               streamed in 65,536-item chunks over 786,432 items, and the
               same users' dense and streamed ranks over a catalog cut to
               100,000 items whose second half copies its first (exact
               ties), held equal element for element.
 13. ring — the preset with spmm_backend="ring" on a one-card mesh of
               four model ranks, all on the card (rows_u 12,288, rows_i
               10,240; NCCL refuses two ranks on one card, so one process
               drives the ring and each exchange copies a block into a new
               buffer on a side stream); the same bundle and weights. K6
               (`ring_segsum_f32`, and `ring_wsegsum_f32` with sym_sqrt
               weights) on interval 0, both directions, against its plain
               ring in f64 and the unsharded K1/K2 sum, its backward (the
               ring on the transpose plans) against the plain transpose
               ring in f64; ring, plain, K1/K2 and library times and the
               bound. The ring encode (192 K6 launches, no K1) against the
               "pallas" encode (rtol 1e-4, atol 1e-5 x max|value|) and the
               plain propagation in f64; a keepRate-1 step against the
               "pallas" step (192 + 192 launches; each hop's leaky-relu on
               the ring's side of the kink); the sym_sqrt encode and step
               and the 'mean' encode (no K6 launch) against the plain path
               in f64; `Trainer(mesh=...).run()` for one epoch with its
               evaluations, its checkpoint restored into a "pallas"
               `Trainer` bit for bit (params and Adam moments).
 14. probes — P1, the row gather (csrc/probes.cu), in every mode (f32 and
               bf16 tables; runs of 1, 4, 8, 16 rows; 1, 2, 4, 8 loads in
               flight) on the probe's shape (1,048,576 rows gathered from a
               1,048,576 x 64 table) and on the gowalla hops' edge streams,
               against its plain version summed in f64 (atol f32 eps x rows
               x max|x|); P2, the ablated segment-sum (K1's kAblate mode),
               on interval 0's gowalla and flagship hops, exactly; then,
               counts set to 0, the probe CLI's measurements
               (`probes.run`): P1's sweeps on an HBM-size and an L2-size
               table, the run and tile factors of the CSR plans, and the
               split of K1's time (P1 on the hop's stream, P2, K1; walk =
               P2 - P1 logged, not checked) on both bundles' interval 0.
               Each P1 record holds the CUDA kernels one call makes; its
               `schedule` log line the modelled lane layout, chunks and
               grid.
 15. bf16 mode — the CLI's `--bf16` (`main.build_config`: bf16 tables,
               fusion_dtype="bf16", the stable softmax) on the gowalla
               preset, served by a `Recommender` on phase 5's weights:
               five encodes (12 segsum_bf16 launches each) with the same
               bits, held against the f32 encode at JAX's bf16 bound (rtol
               and atol 0.05) and against its reference (the bf16 tables
               summed hop by hop in f64, then the same bf16 fusion stack)
               within 2 bf16 ulps of the largest |value|; at keepRate 1 on
               phase 6's batch, the step's losses against the f32 step's
               at JAX's bound (12 + 12 launches), then 3 steps with TF1
               Adam, finite; encode and step ms.
 16. per-token attention — per_token_seq_attention at gowalla width
               (pos_length 200, 16 heads), f32 and bf16: full-catalog
               scores of 256 test users (padded sequences) against an f64
               plain reference of the per-token branch on the same
               encodings; 3 steps with TF1 Adam at keepRate 1 on phase 6's
               batch (12 + 12 K1 launches each), finite; ms.
 17. flagship bf16_b4096 — scripts/bench_1m.py's bf16_b4096 recipe
               (batch 4096, remat, fusion_chunk_rows 32,768, bf16 fusion,
               stable softmax, bf16 tables, no fold) on phase 12's bundle
               through a `Trainer`: the encode (84 segsum_acc_bf16
               launches); four synchronised steps at keepRate 0.5 (168 +
               84 K3 bf16 launches each), finite, with the peak device
               memory, and a profiler pass over two more; the bf16
               stream's `chunked_topk` (top 10 of 786,432 for 256 users)
               against the exact f32 one: its scores the f32 scores of its
               ids (rtol 1e-6), each at least the exact k-th score less
               the bf16 stream's rounding bound (`check_bf16_selection`),
               both timed; a streamed full-sort evaluation of the 4,096
               test users.
 18. TF1 import — tests/fixtures/tf_reference_tiny.npz (the executed TF1
               reference) through the port's `npz_getter` and
               `map_reference_params`, served by a `Recommender` on the
               card: the test batch's candidate scores against the
               reference's (rtol 1e-4, atol 1e-5), HR exact, NDCG rtol
               1e-6; `Trainer.load_imported_params` and one finite step.
 19. user path — a seeded raw log of 1.5M user,item,timestamp events
               (~49k users, ~41k items, power-law popularity) through
               `python -m sagnn_tpu_torch.preprocess` (5-core, 3
               intervals), timed; training on it at the gowalla preset's
               widths under the wedge watchdog `main --supervise` builds,
               polled every second, the child SIGSTOPped at its first step
               line: rc 0 after one recovery (WEDGE, the preemption
               checkpoint, the CUDA probe, the resume), no staging file,
               history.json through the last epoch; the checkpoint served
               by `Recommender.from_checkpoint` on one device and over 4
               catalog shards on the card (12 K1 launches per encode,
               each encode held against the plain backend on this graph
               with its propagation in f64; top 10 for 256 users agree)
               and by the serve CLI. Logged: the CPU a child burns while
               blocked on a device op.
 20. sharded serving — top-10 over 4 catalog ranks on the card against
               the single-device path on the same queries: phase 5's
               gowalla encodings (40,960 items) dense and streamed, the
               bf16_b4096 flagship's 786,432 items (streamed by the auto
               policy), both timed.
 21. profiler trace — `main.profile_epoch` (what --profile_dir runs) on
               a gowalla `Trainer`: a trace that parses with CPU op
               events, state and RNG bit-equal after the restore, 12 + 12
               K1 launches per step, a positive edge rate; its CUDA kernel
               events logged.
Every segment-sum mode (K1-K4, K6, P2; forward and backward), K5 (forward
and dw) and every P1 mode is launched twice on the same inputs in its
phase and must give the same bits (`check_repeatable`); before the kernels line each segment-sum record logs
the time of each hop, the i-hop / u-hop ratio and its share of the bound
(`schedule_report`). Every time in the kernels line is device time per
call: CUDA events around back-to-back calls queued on the card, so that
the host's cost of making them drops out (`kernel_ms`,
`utils/profiling.device_ms`), the kernel's, its plain version's and the
library call's alike.
Each phase prints its time. Prints a `main_path` line, a `train` JSON line,
the card's name and power limit, and a `kernels` JSON line, then as the
last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# gowalla-scale synthetic workload (bench.py's node counts and sequence
# lengths; the preset's widths)
NUM_USERS = 49_152
NUM_ITEMS = 40_960
SEQ_LEN_RANGE = (10, 50)
DATA_SEED = 7
PARAM_SEED = 0
SERVE_USERS = 256
EVAL_USERS = 4096
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# a segment-sum against its plain version summed in f64 (`seg_tol`)
F32_EPS = 2.0 ** -23
SEG_TOL = "rtol 1e-5, atol f32 eps * max degree * max|term|"
KERNEL_SOURCE = "sagnn_tpu_torch/csrc/segsum.cu"
KERNEL_REPLACES = "sagnn_tpu/ops/spmm_pallas.py:218"   # _segsum_kernel
BWD_REPLACES = "sagnn_tpu/ops/spmm_pallas.py:485"      # _spmm_bwd
# K2: _segsum_kernel's weighted mode; its backward launches: the dx of
# _spmm_weighted_bwd and the dx, dy of _sddmm_bwd
K2_REPLACES = "sagnn_tpu/ops/spmm_pallas.py:241"
K2_BWD_REPLACES = "sagnn_tpu/ops/spmm_pallas.py:824"
SDDMM_SOURCE = "sagnn_tpu_torch/csrc/sddmm.cu"
K5_REPLACES = "sagnn_tpu/ops/spmm_pallas.py:705"       # _sddmm_kernel
K5_BWD_REPLACES = "sagnn_tpu/ops/spmm_pallas.py:827"   # dw of _spmm_weighted_bwd
# the training step check: losses at rtol 1e-5; each gradient at rtol 1e-4
# and atol 1e-5 x the largest |g| over all parameters
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-4, 1e-5
# the bf16-table step's losses against the exact step's: the table keeps
# ~3 decimal digits
BF16_LOSS_RTOL = 1e-2
# a resumed step against the uninterrupted one: same params, batch and
# dropout masks; only the order of atomic adds may differ
RESUME_RTOL = 1e-5
# the profiler pass over trainer steps on one batch
PROFILE_STEPS, PROFILE_TOP = 3, 10
# host sampling timed per backend over this many batches
SAMPLE_BATCHES = 5
# K3 (the accumulating mode: per source shard or slice), K4 (row-folded
# gathers) and K3 with K4, and the backwards that launch them
K3_REPLACES = "sagnn_tpu/ops/spmm_pallas.py:327"       # zero_init
K4_REPLACES = "sagnn_tpu/ops/spmm_pallas.py:263"       # folded half-select
K34_REPLACES = "sagnn_tpu/ops/spmm_pallas.py:612"      # fold in shard windows
K3_BWD_REPLACES = "sagnn_tpu/ops/spmm_pallas.py:679"   # _spmm_ss_bwd
K4_BWD_REPLACES = "sagnn_tpu/ops/spmm_pallas.py:485"   # _spmm_bwd, folded
# the 1M-user flagship (scripts/bench_1m.py:35-48): its bundle, and the
# exact_b512 recipe's auto shard rows (32 MiB / (4 B x latdim 64)) and
# predicted K3 launches per encode, g x gnn_layer x (S_u + S_i) =
# 3 x 2 x (786,432 / 131,072 + 1,048,576 / 131,072) = 3 x 2 x (6 + 8)
FLAGSHIP = dict(num_users=1_048_576, num_items=786_432,
                total_edges=60_000_000, graph_num=3, test_size=100, seed=0)
FLAGSHIP_SHARD_ROWS = 131_072
FLAGSHIP_ENCODE_LAUNCHES = 84
FLAGSHIP_STEPS = 3          # timed Trainer steps at keepRate 0.5
# the flagship's dense-vs-streamed full-sort check: a catalog cut to fit
# dense scoring and not a multiple of the 65,536-item chunk
FULL_SORT_CUT_ITEMS = 100_000
# phase 14, the probes (P1, P2): their sources and the TPU kernels they
# replace (the pallas_call of make_dma_gather, kernel dma_kernel :100-134;
# of ablated_segsum, kernel ablate_kernel :94-104)
PROBES_SOURCE = "sagnn_tpu_torch/csrc/probes.cu"
P1_REPLACES = "scripts/probe_dma_gather.py:149"
P2_REPLACES = "scripts/probe_overhead.py:122"
# phases 15-18, the throughput mode and the TF1 import. A bf16 fusion
# stack against the f32 one: the JAX package's own bound
# (tests/test_variants.py:287-310)
BF16_FUSION_RTOL = BF16_FUSION_ATOL = 0.05
# the --bf16 encode against its reference (the bf16 tables summed in f64
# hop by hop, then the same bf16 fusion stack), in bf16 ulps of the
# largest |value| (`bf16_ulps`); the per-token branch in bf16 against its
# f64 reference, in bf16 ulps of the largest |score|
BF16_REF_ULPS = 2.0
PER_TOKEN_BF16_ULPS = 8.0
# the per-token branch in f32 against its f64 reference: rtol, and atol
# as a share of the largest |score|
PER_TOKEN_RTOL, PER_TOKEN_ATOL_SHARE = 1e-4, 1e-5
TRAIN_STEPS_NEW = 3         # steps of the --bf16 and per-token models
FLAGSHIP_BF16_STEPS = 4     # timed bf16_b4096 Trainer steps
# the bf16 stream's top-k: returned scores are the f32 scores of the
# returned ids (rtol 1e-6); each is at least the exact k-th score less the
# stream's rounding bound (`check_bf16_selection`)
TOPK_RERANK_RTOL = 1e-6
TF1_FIXTURE = "tests/fixtures/tf_reference_tiny.npz"


def log(*a):
    print(*a, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    from sagnn_tpu_torch.utils.profiling import cuda_ms as timed
    return timed(fn, iters, warmup)


def kernel_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() with the host's cost of the calls taken out
    (`profiling.device_ms`): every time in a kernel record (the kernel's,
    its plain version's, the library call's) is taken so."""
    from sagnn_tpu_torch.utils.profiling import device_ms
    return device_ms(fn, iters, warmup)


def sharded_row_ptr(ptr_ss):
    """The row pointers of the whole plan whose shards `ptr_ss` [S, T+1]
    are (row t's edges summed over the shards)."""
    import torch
    deg = (ptr_ss[:, 1:] - ptr_ss[:, :-1]).sum(0)
    return torch.cat([deg.new_zeros(1), torch.cumsum(deg, 0)])


def seg_tol(ptr, term_max: float) -> tuple[float, float]:
    """(rtol, atol) for a segment-sum in f32 against its sum in f64: rtol
    1e-5, and an atol that bounds the f32 rounding of the hottest row's
    sum, the f32 epsilon times max degree * `term_max` (the largest |term|:
    max|x| of the table, times max|w| where the sum is weighted), a bound
    on that row's sum of absolute values. The rounding grows with the
    row's length (about as the degree for N(0, 1) terms), so the bound
    does too."""
    deg = int((ptr[1:] - ptr[:-1]).max()) if ptr.numel() > 1 else 0
    return 1e-5, F32_EPS * max(1, deg) * term_max


def amax(t) -> float:
    """max |t|, the largest term a segment-sum over `t` adds."""
    return float(t.abs().max()) if t.numel() else 0.0


def expect_launches(got: dict, what: str, **want) -> None:
    """Fails unless the launch counts are `want` (every other kernel 0)."""
    full = {name: want.get(name, 0) for name in got}
    check(got == full, f"{what}: launches {got}, expected {full}")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def tolerance_used(got, want, rtol, atol) -> tuple[float, float]:
    """(max abs error, largest share of the tolerance atol + rtol * |want|
    used); the share is inf where got is not finite."""
    import torch
    got, want = got.double(), want.double()
    if not got.numel():
        return 0.0, 0.0
    if not bool(torch.isfinite(got).all()):
        return math.inf, math.inf
    diff = (got - want).abs()
    return (float(diff.max()),
            float((diff / (atol + rtol * want.abs())).max()))


def check_close(got, want, rtol, atol, what) -> float:
    """Fails unless |got - want| <= atol + rtol * |want| everywhere and got
    is finite; logs the largest share of the tolerance used. Returns the
    max abs error."""
    err, used = tolerance_used(got, want, rtol, atol)
    check(used <= 1.0,
          f"{what}: max abs err {err:.3e} (rtol {rtol}, atol {atol:.2e})")
    log(f"  {what}: max abs err {err:.3e}, {used:.2f} of the tolerance")
    return err


def check_repeatable(fn, what) -> None:
    """Fails unless two calls of fn give the same bits: no kernel has float
    atomics, and each sums in an order fixed by its inputs alone (the
    segment-sum's rows by the plan, K5's scores by the lane layout, P1's
    chunks by the id count)."""
    import torch
    a, b = fn(), fn()
    torch.cuda.synchronize()
    check(torch.equal(a, b), f"{what}: two launches, different bits")


def cuda_kernels_per_call(fn) -> int | None:
    """The CUDA kernels one call of fn launches, counted by torch.profiler
    (memsets and copies left out); None (logged) where the profiler saw no
    device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    if not events:
        log("  cuda_kernels_per_call: no device events; not measured")
        return None
    return sum(e.count for e in events
               if not e.key.lower().startswith(("memset", "memcpy")))


def sddmm_layout(rec, slots, d, sm_count, edges, runs) -> None:
    """A K5 record's `schedule` log line: the lane layout and grid that
    `spmm_cuda.sddmm_schedule` gives at the hop's sizes, and `runs`, the
    plan's runs of equal targets in each span of SDDMM_SPAN slots over its
    `edges` real edges (the y rows the schedule loads). These are the
    host's model of the launch, not counted on the card, so they stay out
    of the record."""
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    sched = sc.sddmm_schedule(slots, d, sm_count)
    log(f"schedule {rec['name']} (modelled: layout from sddmm_schedule, "
        f"runs from the plan): {sched.vec} values ({sched.vec * 4} bytes) "
        f"per lane, {sched.lanes} lanes per row, "
        f"{sched.rows_per_instruction} rows per warp load, "
        f"{sc.SDDMM_BATCH} edges in flight per group, {sched.blocks} blocks;"
        f" runs per span over the pair {runs} for {edges} edges. Measured: "
        f"CUDA kernels per call {rec['cuda_kernels_per_call']}; "
        f"{rec['ms']:.4f} ms is {rec['bound_ms'] / rec['ms']:.3f} of the "
        f"bound {rec['bound_ms']:.4f} ms")


def serial_items(ptrs, n_slots, d) -> int:
    """The items (row ends and edges) that one warp of the segment-sum
    kernel walks in series, summed over the launches whose row pointers
    are `ptrs` (each with `n_slots` source slots): a launch's pieces of
    PIECE_ITEMS over the warps of its grid as `segsum_schedule` sizes it
    on this card, times PIECE_ITEMS."""
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    total = 0
    for ptr in ptrs:
        t = ptr.numel() - 1
        pieces = -(-(t + int(ptr[-1] - ptr[0])) // sc.PIECE_ITEMS)
        warps = sc.segsum_schedule(t, n_slots, d, sc._sm_count(0)).blocks \
            * sc.WARPS_PER_BLOCK
        total += -(-pieces // warps) * sc.PIECE_ITEMS
    return total


def schedule_report(records) -> None:
    """Each segment-sum record (K1-K4, K6, P2; forward and backward): the
    time of each hop, the i-hop over the u-hop (a gowalla interval's two
    hops have the same edge count, so a ratio near 1 says that no row
    paces a hop) and the share of the bound it reaches. One call of a
    mode is one CUDA kernel (a sharded call: one per shard); the arrival
    counters are zeroed once, when a stream's scratch is allocated."""
    for r in records.values():
        if not r["name"].startswith(("segsum", "wsegsum", "ring_")):
            continue
        u, i = r["per_direction"]["u"]["ms"], r["per_direction"]["i"]["ms"]
        r.update(u_ms=u, i_ms=i, i_over_u=i / u,
                 bound_share=r["bound_ms"] / r["ms"],
                 cuda_kernels_per_call=(
                     "one per shard" if r["name"].startswith(
                         ("segsum_acc", "segsum_fold_acc")) else "one"))
        log(f"schedule {r['name']}: u-hop {u:.4f} ms, i-hop {i:.4f} ms, "
            f"i/u {i / u:.2f}; {r['ms']:.4f} ms is "
            f"{r['bound_share']:.3f} of the bound {r['bound_ms']:.4f} ms")


def plain_attention(x_src, x_tgt, fwd_src, fwd_tgt, fwd_ptr, bwd_src,
                    bwd_ptr, to_bwd, temperature=None, exact=True):
    """`ops.edge_attention.attention_propagate` through the plain versions
    of K5 and K2 (differentiable by autograd, f64 with f64 inputs)."""
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.ops.edge_attention import edge_softmax

    temp = float(x_src.shape[-1]) ** 0.5 if temperature is None \
        else temperature
    s = sc.sddmm_apply_plain(x_src, x_tgt, fwd_src, fwd_tgt, fwd_ptr,
                             exact) / temp
    w = edge_softmax(s, fwd_tgt, fwd_ptr)
    return sc.spmm_weighted_apply_plain(x_src, w, fwd_src, fwd_ptr, exact)


def _plain_spmm(x, src, ptr, _bwd_src, _bwd_ptr, exact=True, _folded=False):
    """`spmm` through K1's plain version (differentiable by autograd; the
    fold changes no value)."""
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    return sc.spmm_apply_plain(x, src, ptr, exact)


def _plain_spmm_src_sharded(x, src, ptr, _bwd_src, _bwd_ptr, shard_rows,
                            exact=True, _folded=False):
    """`spmm_src_sharded` through K3's plain version (per shard gather +
    scatter_add_, differentiable by autograd)."""
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    return sc.spmm_apply_src_sharded_plain(x, src, ptr, shard_rows, exact)


def _plain_spmm_weighted(x, w, src, _tgt, ptr, _bwd_src, _bwd_ptr, _to_bwd,
                         exact=True):
    """`spmm_weighted` through K2's plain version."""
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    return sc.spmm_weighted_apply_plain(x, w, src, ptr, exact)


def _plain_ring_spmm(blocks, fwd, _bwd, k, mesh):
    """`ring_spmm` through K6's plain version, the same ring
    (differentiable by autograd)."""
    from sagnn_tpu_torch.parallel.edge_partition import ring_spmm_apply_plain
    return ring_spmm_apply_plain(blocks, fwd, k, mesh)


@contextlib.contextmanager
def _hop_relu(relu):
    """While active, each propagation hop's leaky-relu (and nothing else's)
    is `relu`."""
    from sagnn_tpu_torch.models import selfgnn

    propagation, real = selfgnn._interval_propagation, selfgnn.leaky_relu

    def wrapped(*args, **kw):
        selfgnn.leaky_relu = relu
        try:
            return propagation(*args, **kw)
        finally:
            selfgnn.leaky_relu = real

    selfgnn._interval_propagation = wrapped
    try:
        yield
    finally:
        selfgnn._interval_propagation = propagation


@contextlib.contextmanager
def deterministic_algorithms():
    """While active, PyTorch runs its deterministic implementations of its
    own ops (and warns where it has none), so that a step repeats bit for
    bit; the kernels are deterministic either way."""
    import torch
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def kernel_kinks(kinks: list):
    """While active, each propagation hop of the kernel path records on
    `kinks` which side of the leaky-relu's kink its aggregate lies on
    (aggregate > 0), in call order."""
    from sagnn_tpu_torch.models import selfgnn
    real = selfgnn.leaky_relu

    def record(x, leaky):
        kinks.append(x.detach() > 0)
        return real(x, leaky)

    with _hop_relu(record):
        yield


@contextlib.contextmanager
def f64_propagation(kinks: list | None = None):
    """While active, `_interval_propagation` is the plain reference of the
    kernel path: every hop through the plain versions (K1, K2, K3, K6, and
    K5 with the edge softmax), on the embedding tables cast to f64; the node states
    come back in f32. The model it serves runs the "pallas" backend.

    kinks: the kernel path's hop signs (`kernel_kinks`), for a gradient
    check. Each hop's leaky-relu then takes the branch the kernel path
    took. Where an aggregate lies within f32 rounding of 0, f32 and f64
    can fall on either side of the kink, and the gradient at that element
    then differs by (1 - leaky)·|g|, which no rounding tolerance holds
    (measured on the card: the same f32-vs-f64 gradient gap in the plain
    f32 backend and the kernel path, none with leaky = 1)."""
    import torch
    from sagnn_tpu_torch.models import selfgnn

    patched = {"spmm": _plain_spmm, "spmm_weighted": _plain_spmm_weighted,
               "attention_propagate": plain_attention,
               "spmm_src_sharded": _plain_spmm_src_sharded,
               "ring_spmm": _plain_ring_spmm}
    saved = {name: getattr(selfgnn, name) for name in patched}
    propagation = selfgnn._interval_propagation

    def f64(p, graphs_, cfg_, nu_, ni_, edge_weights=None, mesh=None):
        p64 = dict(p)
        for key in ("reg/u_embed", "reg/i_embed"):
            p64[key] = p[key].double()
        uv, iv = propagation(p64, graphs_, cfg_, nu_, ni_, edge_weights,
                             mesh=mesh)
        return uv.float(), iv.float()

    def replay(x, leaky):
        return torch.where(kinks.pop(0), x, leaky * x)

    for name, fn in patched.items():
        setattr(selfgnn, name, fn)
    selfgnn._interval_propagation = f64
    try:
        if kinks is None:
            yield
        else:
            with _hop_relu(replay):
                yield
            check(not kinks, "every recorded hop replayed")
    finally:
        selfgnn._interval_propagation = propagation
        for name, fn in saved.items():
            setattr(selfgnn, name, fn)


def loss_and_grads(model, leaves, graphs, batch, tc, gen=None):
    """(preLoss, sslloss, {param: gradient}) of one step's whole loss."""
    import torch
    from sagnn_tpu_torch.models import selfgnn

    keys = sorted(leaves)
    pre, ssl, _ = model.train_losses(leaves, graphs, batch, gen)
    loss = pre + tc.reg * selfgnn.reg_loss(leaves) + tc.ssl_reg * ssl
    grads = torch.autograd.grad(loss, [leaves[k] for k in keys],
                                allow_unused=True)
    return pre.detach(), ssl.detach(), {
        k: torch.zeros_like(leaves[k]) if g is None else g
        for k, g in zip(keys, grads)}


def check_step(got, want, what) -> tuple[float, str]:
    """Losses at LOSS_RTOL and every gradient at GRAD_RTOL with atol
    GRAD_ATOL_SHARE x the largest |g| over all parameters; returns the
    largest share of the gradient tolerance used and its parameter."""
    pre_k, ssl_k, g_k = got
    pre_r, ssl_r, g_r = want
    check_close(pre_k.reshape(1), pre_r.reshape(1), LOSS_RTOL, 0.0,
                f"{what} preLoss kernel vs plain f64")
    check_close(ssl_k.reshape(1), ssl_r.reshape(1), LOSS_RTOL, 0.0,
                f"{what} sslloss kernel vs plain f64")
    g_max = max(float(g.abs().max()) for g in g_r.values())
    grad_atol = GRAD_ATOL_SHARE * g_max
    used = {k: tolerance_used(g_k[k], g_r[k], GRAD_RTOL, grad_atol)
            for k in g_r}
    worst = sorted(used.items(), key=lambda kv: -kv[1][1])
    log(f"  {what} gradients kernel vs plain f64 (rtol {GRAD_RTOL}, atol "
        f"{grad_atol:.3e} = {GRAD_ATOL_SHARE} x max|g| {g_max:.3e}); "
        "largest shares of the tolerance: " + ", ".join(
            f"{k} {s:.2f} (err {e:.2e})" for k, (e, s) in worst[:4]))
    check(worst[0][1][1] <= 1.0,
          f"{what} gradient {worst[0][0]}: {worst[0][1][1]:.2f} of the "
          "tolerance")
    return worst[0][1][1], worst[0][0]


def kernel_phase(graphs, device) -> dict:
    """Kernel vs plain (and library) on interval 0, both directions, plus an
    empty graph and a graph with empty rows. Returns per-kernel records."""
    import torch
    from sagnn_tpu_torch.ops import spmm_cuda as sc

    gen = torch.Generator(device=device).manual_seed(1)
    D = 64
    records = {}
    for exact, name in ((True, "segsum_f32"), (False, "segsum_bf16")):
        rec = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
               "replaces": KERNEL_REPLACES, "mode": "exact f32 table"
               if exact else "bf16 table, f32 accumulation",
               "per_direction": {}, "max_abs_err": 0.0}
        totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        for d, n_src in (("u", NUM_ITEMS), ("i", NUM_USERS)):
            src = graphs[f"{d}_src"][0]
            ptr = graphs[f"{d}_ptr"][0]
            n_tgt = ptr.numel() - 1
            n_edges = int(ptr[-1])
            x = torch.randn((n_src, D), generator=gen, device=device)
            out_k = sc.spmm_apply(x, src, ptr, exact)
            # the plain version, summed in f64: the check then measures the
            # kernel's own f32 rounding, not the order of index_add_'s
            # atomics (the f32 plain version is timed and checked too)
            out_p = sc.spmm_apply_plain(x.double(), src, ptr, exact)
            out_p32 = sc.spmm_apply_plain(x, src, ptr, exact)
            torch.cuda.synchronize()
            rtol, atol = seg_tol(ptr, amax(x))
            err = check_close(out_k, out_p, rtol, atol, f"{name}[{d}]")
            check_repeatable(lambda: sc.spmm_apply(x, src, ptr, exact),
                             f"{name}[{d}]")
            log(f"  plain f32[{d}] vs f64: max abs err "
                f"{max_err(out_p32, out_p):.3e}")
            ms = kernel_ms(lambda: sc.spmm_apply(x, src, ptr, exact))
            plain_ms = kernel_ms(lambda: sc.spmm_apply_plain(x, src, ptr,
                                                             exact))
            # library yardstick: cuSPARSE SpMM on a unit-valued CSR matrix,
            # built outside the timed region (bf16 mode: on the
            # bf16-rounded table held in f32)
            a = torch.sparse_csr_tensor(
                ptr.long(), src[:n_edges].long(),
                torch.ones(n_edges, device=device), size=(n_tgt, n_src),
                check_invariants=False)
            xl = x if exact else x.to(torch.bfloat16).float()
            out_l = torch.sparse.mm(a, xl)
            check_close(out_l, out_p, rtol, atol, f"library[{d}]")
            library_ms = kernel_ms(lambda: torch.sparse.mm(a, xl))
            elem = 4 if exact else 2
            # bytes the function must move: the table once, the ids and
            # row pointers once, the output once
            nbytes = (n_src * D * elem + n_edges * 4 + (n_tgt + 1) * 4
                      + n_tgt * D * 4)
            flops = n_edges * D
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           flops / F32_FLOPS) * 1e3
            max_deg = int((ptr[1:] - ptr[:-1]).max())
            rec["per_direction"][d] = dict(
                num_tgt=n_tgt, num_src=n_src, edges=n_edges, d=D,
                max_degree=max_deg, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                unique_bytes=nbytes, gathered_bytes=n_edges * D * elem,
                serial_items=serial_items([ptr], src.numel(), D),
                max_abs_err=err)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("library_ms", library_ms),
                           ("bound_ms", bound_ms)):
                totals[key] += v
        # an empty interval (all padding) and a graph with empty rows
        x = torch.randn((300, D), generator=gen, device=device)
        empty_ptr = torch.zeros(129, dtype=torch.int32, device=device)
        empty_src = torch.zeros(512, dtype=torch.int32, device=device)
        out = sc.spmm_apply(x, empty_src, empty_ptr, exact)
        torch.cuda.synchronize()
        check(out.shape == (128, D) and not bool(out.any()),
              f"{name}: empty graph must give zeros")
        deg = torch.randint(0, 4, (1000,), generator=gen, device=device)
        deg[::2] = 0
        ptr = torch.zeros(1001, dtype=torch.int32, device=device)
        ptr[1:] = torch.cumsum(deg, 0).to(torch.int32)
        src = torch.randint(0, 300, (int(ptr[-1]) + 40,), generator=gen,
                            device=device, dtype=torch.int32)
        out = sc.spmm_apply(x, src, ptr, exact)
        want = sc.spmm_apply_plain(x.double(), src, ptr, exact)
        torch.cuda.synchronize()
        rtol, atol = seg_tol(ptr, amax(x))
        err = check_close(out, want, rtol, atol, f"{name}: empty rows")
        check(not bool(out[::2].any()), f"{name}: empty rows must be zero")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec.update(totals)
        rec["bound_by"] = "bytes"
        rec["bound_counts"] = ("bytes: the source table once, the source "
                               "ids and row pointers once, the f32 output "
                               "once, at 3.35e12 B/s; operations: one f32 "
                               "add per gathered value at 67e12 FLOP/s")
        rec["tolerance"] = SEG_TOL
        records[name] = rec
        log(f"{name}: u {rec['per_direction']['u']['ms']:.4f} ms, "
            f"i {rec['per_direction']['i']['ms']:.4f} ms; plain "
            f"{rec['plain_ms']:.4f} ms; library {rec['library_ms']:.4f} ms;"
            f" bound {rec['bound_ms']:.4f} ms; max abs err "
            f"{rec['max_abs_err']:.3e}")
    return records


def backward_phase(graphs, device) -> dict:
    """K1's backward (`SpmmFunction`: the kernel on the transpose plan) on
    interval 0, both directions, exact and bf16: dx of a seeded random
    cotangent through `torch.autograd.grad` against the plain transpose
    sum in f64. Times the backward's launch alone (`spmm_apply` on the
    transpose plan, the launch the backward makes), the whole autograd
    backward, the plain version and the library call. Returns per-kernel
    records."""
    import torch
    from sagnn_tpu_torch.ops import spmm_cuda as sc

    gen = torch.Generator(device=device).manual_seed(2)
    D = 64
    records = {}
    for exact, name in ((True, "segsum_f32_bwd"),
                        (False, "segsum_bf16_bwd")):
        rec = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
               "replaces": BWD_REPLACES, "mode": "backward, dx = A^T g on "
               "the transpose plan; " + ("exact f32 cotangent" if exact
                                         else "cotangent cast to bf16, "
                                         "f32 accumulation"),
               "per_direction": {}, "max_abs_err": 0.0}
        totals = dict(ms=0.0, autograd_ms=0.0, plain_ms=0.0, library_ms=0.0,
                      bound_ms=0.0)
        for d in ("u", "i"):
            o = "i" if d == "u" else "u"
            fsrc, fptr = graphs[f"{d}_src"][0], graphs[f"{d}_ptr"][0]
            bsrc, bptr = graphs[f"{o}_src"][0], graphs[f"{o}_ptr"][0]
            n_x, n_g = bptr.numel() - 1, fptr.numel() - 1
            n_edges = int(bptr[-1])
            x = torch.randn((n_x, D), generator=gen, device=device,
                            requires_grad=True)
            g = torch.randn((n_g, D), generator=gen, device=device)
            out = sc.spmm(x, fsrc, fptr, bsrc, bptr, exact)
            dx, = torch.autograd.grad(out, x, g, retain_graph=True)
            want = sc.spmm_apply_plain(g.double(), bsrc, bptr, exact)
            torch.cuda.synchronize()
            rtol, atol = seg_tol(bptr, amax(g))
            err = check_close(dx, want, rtol, atol, f"{name}[{d}-hop dx]")
            check_repeatable(lambda: torch.autograd.grad(
                out, x, g, retain_graph=True)[0], f"{name}[{d}-hop dx]")
            ms = kernel_ms(lambda: sc.spmm_apply(g, bsrc, bptr, exact))
            autograd_ms = kernel_ms(lambda: torch.autograd.grad(
                out, x, g, retain_graph=True))
            plain_ms = kernel_ms(lambda: sc.spmm_apply_plain(g, bsrc, bptr,
                                                             exact))
            # library yardstick: cuSPARSE on the transposed unit CSR, built
            # outside the timed region
            at = torch.sparse_csr_tensor(
                bptr.long(), bsrc[:n_edges].long(),
                torch.ones(n_edges, device=device), size=(n_x, n_g),
                check_invariants=False)
            gl = g if exact else g.to(torch.bfloat16).float()
            check_close(torch.sparse.mm(at, gl), want, rtol, atol,
                        f"library[{d}-hop dx]")
            library_ms = kernel_ms(lambda: torch.sparse.mm(at, gl))
            elem = 4 if exact else 2
            # the forward's bytes with the roles swapped: the cotangent
            # table once, the transpose plan's ids and row pointers once,
            # the f32 dx once
            nbytes = (n_g * D * elem + n_edges * 4 + (n_x + 1) * 4
                      + n_x * D * 4)
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           n_edges * D / F32_FLOPS) * 1e3
            rec["per_direction"][d] = dict(
                plan=o, num_tgt=n_x, num_src=n_g, edges=n_edges, d=D,
                max_degree=int((bptr[1:] - bptr[:-1]).max()), ms=ms,
                autograd_ms=autograd_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                unique_bytes=nbytes, max_abs_err=err)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            for key in totals:
                totals[key] += rec["per_direction"][d][key]
        rec.update(totals)
        rec["bound_by"] = "bytes"
        rec["tolerance"] = SEG_TOL + " (of the transpose plan)"
        records[name] = rec
        log(f"{name}: u-hop dx {rec['per_direction']['u']['ms']:.4f} ms, "
            f"i-hop dx {rec['per_direction']['i']['ms']:.4f} ms; autograd "
            f"{rec['autograd_ms']:.4f} ms; plain {rec['plain_ms']:.4f} ms; "
            f"library {rec['library_ms']:.4f} ms; bound "
            f"{rec['bound_ms']:.4f} ms; max abs err {rec['max_abs_err']:.3e}")
    return records


def bf16_propagation_reference(params, graphs, mc, num_users, num_items,
                               attr="spmm"):
    """The bf16-table propagation, held hop by hop. A first pass runs the
    kernel path and keeps each hop's inputs and output; a second pass
    builds the reference chain in f64, where each hop is the plain version
    (the bf16-rounded inputs, summed in f64) of the inputs the kernel path
    gave that hop. Each hop's kernel output is checked against it: the
    segment-sum (attr "spmm", K1) at the segment-sum tolerance, the
    attention hop (attr "attention_propagate", K5 + softmax + K2) at
    rtol 1e-4, atol 1e-5. A reference fed its own f64 chain would round
    some inputs of the next hop to the neighbouring bf16 value and differ
    by a bf16 ulp, not by the kernels' f32 rounding.
    Returns (user_vec, item_vec) of the reference, in f64."""
    from sagnn_tpu_torch.models import selfgnn
    from sagnn_tpu_torch.ops import spmm_cuda as sc

    if attr == "spmm":
        def plain(x, src, ptr, _bwd_src, _bwd_ptr, exact, _folded=False):
            return (sc.spmm_apply_plain(x.double(), src, ptr, exact),
                    seg_tol(ptr, amax(x)))
    elif attr == "spmm_src_sharded":
        def plain(x, src, ptr, _bwd_src, _bwd_ptr, shard_rows, exact,
                  _folded=False):
            return (sc.spmm_apply_src_sharded_plain(x.double(), src, ptr,
                                                    shard_rows, exact),
                    seg_tol(sharded_row_ptr(ptr), amax(x)))
    else:
        def plain(x, x_tgt, *plans, exact):
            return (plain_attention(x.double(), x_tgt.double(), *plans,
                                    exact=exact), (1e-4, 1e-5))

    hops = []
    kernel = getattr(selfgnn, attr)

    def record(*args, **kw):
        out = kernel(*args, **kw)
        hops.append((args, kw, out))
        return out

    def replay(*_args, **_kw):
        args, kw, got = hops[len(done)]
        want, (rtol, atol) = plain(*args, **kw)
        done.append(check_close(got, want, rtol, atol,
                                f"bf16 hop {len(done)}"))
        return want

    done = []
    p64 = dict(params)
    for key in ("reg/u_embed", "reg/i_embed"):
        p64[key] = p64[key].double()
    try:
        setattr(selfgnn, attr, record)
        selfgnn._interval_propagation(params, graphs, mc, num_users,
                                      num_items)
        setattr(selfgnn, attr, replay)
        ref = selfgnn._interval_propagation(p64, graphs, mc, num_users,
                                            num_items)
    finally:
        setattr(selfgnn, attr, kernel)
    check(len(done) == len(hops) == mc.graph_num * mc.gnn_layer * 2,
          "bf16 reference: every hop replayed")
    return ref


def train_step_phase(cfg, bundle, params, graphs, device) -> dict:
    """One full-width training step at keep_rate 1 through
    `SelfGNN.train_losses`: the kernel path against the plain backend with
    its propagation summed in f64 (losses and every parameter's gradient),
    with the launch counts read around it; the same step on the bf16
    table; then the device time of the step and of its parts."""
    import torch
    from sagnn_tpu_torch.data.sampler import Sampler
    from sagnn_tpu_torch.models import selfgnn
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.train.optim import TF1Adam

    tc = cfg.train
    mc = dataclasses.replace(cfg.model, keep_rate=1.0)
    nu, ni = bundle.num_users, bundle.num_items
    hops = mc.graph_num * mc.gnn_layer * 2
    sampler = Sampler(bundle, batch=tc.batch, samp_num=tc.samp_num,
                      ssl_num=tc.ssl_num, pred_num=tc.pred_num,
                      pos_length=mc.pos_length, test_size=tc.test_size,
                      seed=tc.seed)
    ids = sampler.epoch_user_ids(tc.trn_num)
    t0 = time.perf_counter()
    host_batch = sampler.train_batch(ids[:tc.batch])
    sample_ms = (time.perf_counter() - t0) * 1e3
    batch = host_batch.to(device)
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    keys = sorted(leaves)

    kernel = selfgnn.SelfGNN(mc, nu, ni)
    kinks = []
    sc.reset_launches()
    with kernel_kinks(kinks):
        pre_k, ssl_k, g_k = loss_and_grads(kernel, leaves, graphs, batch, tc)
    torch.cuda.synchronize()
    launches = dict(sc.LAUNCHES)
    log(f"train step launches: {launches}")
    expect_launches(launches, "train step", segsum_f32=hops,
                    segsum_f32_bwd=hops)

    # the reference: the plain version of each hop, summed in f64 (the
    # embedding tables cast to f64 on the way in, the node states back to
    # f32 on the way out), each hop's leaky-relu on the kernel path's side
    # of the kink, everything else in f32
    with f64_propagation(kinks):
        want = loss_and_grads(kernel, leaves, graphs, batch, tc)
    torch.cuda.synchronize()
    g_r = want[2]
    grad_share, grad_worst = check_step((pre_k, ssl_k, g_k), want,
                                        "train step")
    g_max = max(float(g.abs().max()) for g in g_r.values())
    grad_atol = GRAD_ATOL_SHARE * g_max

    # the same step on the bf16 table: its kernels on the path, losses
    # near the exact path's (the table rounds to bf16, ~3 decimal digits)
    bf16 = selfgnn.SelfGNN(dataclasses.replace(mc, spmm_exact=False), nu, ni)
    sc.reset_launches()
    pre_b, ssl_b, g_b = loss_and_grads(bf16, leaves, graphs, batch, tc)
    torch.cuda.synchronize()
    launches_bf16 = dict(sc.LAUNCHES)
    log(f"bf16 train step launches: {launches_bf16}")
    expect_launches(launches_bf16, "bf16 train step", segsum_bf16=hops,
                    segsum_bf16_bwd=hops)
    check_close(pre_b.reshape(1), pre_k.reshape(1), BF16_LOSS_RTOL, 0.0,
                "bf16 train step preLoss vs exact")
    check_close(ssl_b.reshape(1), ssl_k.reshape(1), BF16_LOSS_RTOL, 0.0,
                "bf16 train step sslloss vs exact")
    check(all(bool(torch.isfinite(g).all()) for g in g_b.values()),
          "bf16 train step gradients finite")
    bf16_grad_dev = max(max_err(g_b[k], g_k[k]) for k in keys) / g_max
    log(f"  bf16 step gradients: max abs deviation from the exact step "
        f"{bf16_grad_dev:.3e} x max|g|")
    # the same bf16 step again: PyTorch's default ops sum in no fixed order
    # (logged, not checked)
    g_b2 = loss_and_grads(bf16, leaves, graphs, batch, tc)[2]
    bf16_repeat_dev = max(max_err(g_b2[k], g_b[k]) for k in keys) / g_max
    log(f"  bf16 step repeated: max abs deviation {bf16_repeat_dev:.3e} x "
        f"max|g|")
    del g_b2

    # K4's backward: the same steps with row-folded gathers both ways,
    # each against the unfolded step, both with PyTorch's deterministic
    # algorithms: without them the plain ops' sums vary from run to run,
    # which the bf16 casts of the cotangents amplify past this tolerance
    # (`bf16_repeat_dev` below); with them the two steps can differ only
    # where K4 and K1 do
    fold_launches, fold_dev = {}, {}
    for exact, mode in ((True, "f32"), (False, "bf16")):
        unfolded, fold = (selfgnn.SelfGNN(dataclasses.replace(
            mc, spmm_exact=exact, spmm_fold_gather=f), nu, ni)
            for f in (False, True))
        with deterministic_algorithms():
            pre_r, ssl_r, g_r_ = loss_and_grads(unfolded, leaves, graphs,
                                                batch, tc)
            sc.reset_launches()
            pre_f, ssl_f, g_f = loss_and_grads(fold, leaves, graphs, batch,
                                               tc)
            torch.cuda.synchronize()
        fold_launches[mode] = dict(sc.LAUNCHES)
        expect_launches(fold_launches[mode], f"{mode} fold train step",
                        **{f"segsum_fold_{mode}": hops,
                           f"segsum_fold_{mode}_bwd": hops})
        check_close(pre_f.reshape(1), pre_r.reshape(1), 1e-6, 0.0,
                    f"{mode} fold step preLoss vs unfolded")
        check_close(ssl_f.reshape(1), ssl_r.reshape(1), 1e-6, 0.0,
                    f"{mode} fold step sslloss vs unfolded")
        fold_dev[mode] = max(max_err(g_f[k], g_r_[k]) for k in keys) / g_max
        check(fold_dev[mode] <= GRAD_ATOL_SHARE,
              f"{mode} fold step gradients: {fold_dev[mode]:.3e} x max|g|")
        log(f"  {mode} fold step gradients: max abs deviation from the "
            f"unfolded step {fold_dev[mode]:.3e} x max|g|")

    # keepRate 0.5: remat and chunked fusion (the flagship's memory
    # options) give the same losses and gradients as the step without
    # them from one state of the dropout generator; the recompute must
    # apply the forward's masks
    dropout = dataclasses.replace(mc, keep_rate=0.5)
    remat = dataclasses.replace(dropout, remat_propagation=True,
                                fusion_chunk_rows=16_384)

    def dropout_step(model_cfg, seed):
        model = selfgnn.SelfGNN(model_cfg, nu, ni)
        gen_d = torch.Generator(device=device).manual_seed(seed)
        return loss_and_grads(model, leaves, graphs, batch, tc, gen_d)

    want_d = dropout_step(dropout, 21)
    other_d = dropout_step(dropout, 22)
    sc.reset_launches()
    got_d = dropout_step(remat, 21)
    torch.cuda.synchronize()
    remat_launches = dict(sc.LAUNCHES)
    expect_launches(remat_launches, "keepRate 0.5 remat step",
                    segsum_f32=2 * hops, segsum_f32_bwd=hops)
    check(float(other_d[0]) != float(want_d[0]),
          "keepRate 0.5: another dropout seed gives another loss")
    check_close(got_d[0].reshape(1), want_d[0].reshape(1), LOSS_RTOL, 0.0,
                "keepRate 0.5 remat + chunked fusion preLoss vs without")
    check_close(got_d[1].reshape(1), want_d[1].reshape(1), LOSS_RTOL, 0.0,
                "keepRate 0.5 remat + chunked fusion sslloss vs without")
    gd_max = max(float(g.abs().max()) for g in want_d[2].values())
    remat_share = max(tolerance_used(got_d[2][k], want_d[2][k], GRAD_RTOL,
                                     GRAD_ATOL_SHARE * gd_max)[1]
                      for k in keys)
    check(remat_share <= 1.0, f"keepRate 0.5 remat + chunked fusion "
          f"gradients: {remat_share:.2f} of the tolerance")
    log(f"  keepRate 0.5 remat + chunked fusion vs without: gradients at "
        f"{remat_share:.2f} of the step tolerance; launches "
        f"{ {k: v for k, v in remat_launches.items() if v} }")
    del want_d, other_d, got_d

    # device time of the step (forward + backward of the whole loss) and
    # of its parts, with CUDA events, on the kernel path
    step_ms = cuda_ms(lambda: loss_and_grads(kernel, leaves, graphs, batch,
                                             tc), iters=5, warmup=1)
    uk, ik = leaves["reg/u_embed"], leaves["reg/i_embed"]

    def prop():
        return selfgnn._interval_propagation(leaves, graphs, mc, nu, ni)

    uv, iv = prop()
    cu, ci = torch.randn_like(uv), torch.randn_like(iv)
    prop_fwd_ms = cuda_ms(prop, iters=5, warmup=1)
    prop_fb_ms = cuda_ms(lambda: torch.autograd.grad(
        list(prop()), [uk, ik], [cu, ci]), iters=5, warmup=1)
    uvd, ivd = uv.detach().requires_grad_(), iv.detach().requires_grad_()

    def fusion():
        return selfgnn._temporal_fusion(leaves, uvd, ivd, mc)

    fu, fi = fusion()
    cfu, cfi = torch.randn_like(fu), torch.randn_like(fi)
    fusion_fwd_ms = cuda_ms(fusion, iters=5, warmup=1)
    fusion_fb_ms = cuda_ms(lambda: torch.autograd.grad(
        list(fusion()), [uvd, ivd] + [leaves[k] for k in keys], [cfu, cfi],
        allow_unused=True), iters=5, warmup=1)
    # K1 alone: the step's 12 forward and 12 backward launches on their
    # plans (random tables; a segment-sum's time does not depend on values)
    gen = torch.Generator(device=device).manual_seed(3)
    tables = {"u": torch.randn((nu, 64), generator=gen, device=device),
              "i": torch.randn((ni, 64), generator=gen, device=device)}

    def k1(backward):
        for k in range(mc.graph_num):
            for _ in range(mc.gnn_layer):
                for d, o in (("u", "i"), ("i", "u")):
                    plan, table = (o, d) if backward else (d, o)
                    sc.spmm_apply(tables[table], graphs[f"{plan}_src"][k],
                                  graphs[f"{plan}_ptr"][k])

    k1_fwd_ms = cuda_ms(lambda: k1(False), iters=5, warmup=1)
    k1_bwd_ms = cuda_ms(lambda: k1(True), iters=5, warmup=1)
    opt = TF1Adam(tc.lr, tc.decay, tc.decay_step)
    opt_params = {k: v.detach().clone() for k, v in leaves.items()}
    opt_state = opt.init(opt_params)
    optimizer_ms = cuda_ms(lambda: opt.step(opt_params, g_k, opt_state),
                           iters=10, warmup=2)
    out = {
        "launches_per_step": {k: v for k, v in launches.items() if v},
        "launches_per_bf16_step": {k: v for k, v in launches_bf16.items()
                                   if v},
        "launches_per_fold_step": {m: {k: v for k, v in f.items() if v}
                                   for m, f in fold_launches.items()},
        "fold_grad_dev_over_max_g": fold_dev,
        "dropout_remat_grad_check_share": remat_share,
        "launches_per_dropout_remat_step": {
            k: v for k, v in remat_launches.items() if v},
        "loss_rtol": LOSS_RTOL, "grad_rtol": GRAD_RTOL,
        "grad_atol": grad_atol, "grad_check_share": grad_share,
        "grad_check_worst": grad_worst,
        "bf16_grad_dev_over_max_g": bf16_grad_dev,
        "bf16_repeat_dev_over_max_g": bf16_repeat_dev,
        "step_ms": step_ms, "propagation_fwd_ms": prop_fwd_ms,
        "propagation_bwd_ms": prop_fb_ms - prop_fwd_ms,
        "fusion_fwd_ms": fusion_fwd_ms,
        "fusion_bwd_ms": fusion_fb_ms - fusion_fwd_ms,
        "rest_ms": step_ms - prop_fb_ms - fusion_fb_ms,
        "k1_fwd_ms": k1_fwd_ms, "k1_bwd_ms": k1_bwd_ms,
        "optimizer_ms": optimizer_ms, "host_sample_ms_one_batch": sample_ms,
    }
    log(f"train step {step_ms:.3f} ms (forward + backward): propagation "
        f"{prop_fwd_ms:.3f} + {out['propagation_bwd_ms']:.3f} ms, of which "
        f"K1 {k1_fwd_ms:.3f} + {k1_bwd_ms:.3f} ms; fusion "
        f"{fusion_fwd_ms:.3f} + {out['fusion_bwd_ms']:.3f} ms; rest "
        f"{out['rest_ms']:.3f} ms; optimizer {optimizer_ms:.3f} ms; host "
        f"sampling of one batch {sample_ms:.1f} ms")
    return out, batch


def profiled_ms(fn, n: int) -> tuple[float, dict]:
    """torch.profiler over `n` calls of fn (after one unprofiled call):
    (wall ms per call, {device activity name: device ms per call}), the
    kernels' and copies' own device times; {} where the profiler saw no
    device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms / n, {
        e.key: getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / n
        for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def profile_steps(step, n: int = PROFILE_STEPS) -> dict:
    """torch.profiler over `n` calls of `step` (`profiled_ms`): the
    device's busy share of the window's wall time (the sum of the kernels'
    and copies' device times; the profiler's own host cost lengthens the
    window, so the share is a lower bound) and the top kernels by device
    time, in ms per step. Without device events (a profiler that cannot
    trace the card) it records that and no share."""
    wall_ms, by_name = profiled_ms(step, n)
    if not by_name:
        log("profile: no device events in the trace; busy share not "
            "measured")
        return {"steps": n, "wall_ms_per_step": wall_ms,
                "busy_share": None}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
    out = {"steps": n, "wall_ms_per_step": wall_ms,
           "device_ms_per_step": busy, "busy_share": busy / wall_ms,
           "top_ms_per_step": {k[:100]: v for k, v in top}}
    log(f"profile of {n} train steps: wall {out['wall_ms_per_step']:.2f} "
        f"ms, device {busy:.2f} ms per step (busy "
        f"{out['busy_share']:.2f}); top kernels by device time per step:")
    for k, v in out["top_ms_per_step"].items():
        log(f"  {v:.3f} ms  {k}")
    return out


def training_phase(cfg, bundle, device) -> dict:
    """`Trainer.run()` for one epoch (trn_num / batch steps, keepRate as
    the preset has it) with the native sampler (a failed build fails the
    run), its evaluation and best-NDCG checkpoint; a timed evaluation, a
    full-sort evaluation of every test user (dense over the catalog) and
    a save; a second `Trainer` that restores the checkpoint; one more
    step on each, on the same batch and dropout state; host sampling per
    batch with each sampler backend, and the epoch with the numpy one."""
    import numpy as np
    import torch
    from sagnn_tpu_torch.data.sampler import Sampler
    from sagnn_tpu_torch.models.selfgnn import TrainBatch
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.train.trainer import Trainer
    from sagnn_tpu_torch.utils.profiling import StepTimer

    tc, mc = cfg.train, cfg.model
    hops = mc.graph_num * mc.gnn_layer * 2
    steps = -(-tc.trn_num // tc.batch)
    run_cfg = cfg.replace(train=dataclasses.replace(
        tc, epoch=1, tst_epoch=1, save_path="smoke"))
    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        trainer = Trainer(run_cfg, bundle, ckpt_root=root, device=device,
                          sampler_backend="native")
        out["trainer_init_s"] = time.perf_counter() - t0
        check(trainer.sampler.backend == "native", "the native sampler")
        epoch_s = []
        train_epoch = trainer.train_epoch

        def timed_epoch(*a, **kw):
            t = time.perf_counter()
            res = train_epoch(*a, **kw)
            torch.cuda.synchronize()
            epoch_s.append(time.perf_counter() - t)
            return res

        trainer.train_epoch = timed_epoch
        sc.reset_launches()
        t0 = time.perf_counter()
        best = trainer.run()
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t0
        launches = dict(sc.LAUNCHES)
        log(f"training run launches: {launches}")
        check(trainer.state["step"] == steps == len(trainer.step_stats),
              f"one epoch of {steps} steps")
        # 12 forward + 12 backward per step; 12 forward per evaluation (the
        # epoch's and the final one)
        expect_launches(launches, "training run", segsum_f32=hops * (steps + 2),
                        segsum_f32_bwd=hops * steps)
        stats = trainer.step_stats
        check(all(math.isfinite(s[k]) for s in stats for k in s),
              "every training loss finite")
        for k, v in best.items():
            check(math.isfinite(v) and 0.0 <= v <= 1.0, f"metric {k}={v}")
        check(os.path.exists(os.path.join(root, "smoke", "state")),
              "best-NDCG checkpoint written")
        times = StepTimer(times=trainer.step_timer.times[1:])
        samples = trainer.sample_timer.times
        out.update(
            steps=steps, epoch_s=epoch_s[0], step_ms_mean=times.mean * 1e3,
            step_ms_p50=times.percentile(50) * 1e3,
            step_ms_p95=times.percentile(95) * 1e3,
            host_sample_ms=sum(samples) / len(samples) * 1e3,
            first_preloss=stats[0]["preLoss"],
            last_preloss=stats[-1]["preLoss"],
            launches_run=launches)

        t0 = time.perf_counter()
        metrics = trainer.test_epoch()
        torch.cuda.synchronize()
        out["evaluate_s"] = time.perf_counter() - t0
        out["evaluate_users"] = len(bundle.tst_usrs)
        out["metrics"] = {k: metrics[k] for k in ("HR@10", "NDCG@10")}
        for k, v in metrics.items():
            check(math.isfinite(v) and 0.0 <= v <= 1.0, f"metric {k}={v}")
        log(f"evaluate over {len(bundle.tst_usrs)} users: "
            f"{out['evaluate_s']:.2f} s, HR@10 {metrics['HR@10']:.4f} "
            f"NDCG@10 {metrics['NDCG@10']:.4f} (one epoch from random "
            f"weights)")
        # full sort: every test user against the whole catalog, dense
        # (40,960 items is below DENSE_MAX_ROWS)
        t0 = time.perf_counter()
        metrics = trainer.test_epoch(full_sort=True)
        torch.cuda.synchronize()
        out["full_sort_s"] = time.perf_counter() - t0
        out["full_sort_metrics"] = {k: metrics[k] for k in ("HR@10",
                                                            "NDCG@10")}
        for k, v in metrics.items():
            check(math.isfinite(v) and 0.0 <= v <= 1.0,
                  f"full-sort metric {k}={v}")
        log(f"full-sort evaluate (dense) over {len(bundle.tst_usrs)} users "
            f"x {bundle.num_items} items: {out['full_sort_s']:.2f} s, HR@10 "
            f"{metrics['HR@10']:.4f} NDCG@10 {metrics['NDCG@10']:.4f}")
        t0 = time.perf_counter()
        trainer.ckpt.save(trainer.state, trainer.history, trainer.cfg,
                          rng_state=trainer.capture_rng_state(1))
        out["checkpoint_save_s"] = time.perf_counter() - t0

        resumed = Trainer(run_cfg.replace(train=dataclasses.replace(
            run_cfg.train, epoch=2, load_model="smoke")), bundle,
            ckpt_root=root, device=device, sampler_backend="native")
        t0 = time.perf_counter()
        epoch = resumed.restore_checkpoint()
        torch.cuda.synchronize()
        out["checkpoint_restore_s"] = time.perf_counter() - t0
        check(epoch == 1 and resumed.state["step"] == steps
              and resumed.state["opt_state"].count == steps,
              f"restored epoch {epoch}, step {resumed.state['step']}")
        for k, v in trainer.state["params"].items():
            check(torch.equal(resumed.state["params"][k], v),
                  f"restored param {k}")

        def next_batch(tr):
            ids = tr.sampler.epoch_user_ids(tc.trn_num)
            return tr.sampler.train_batch(ids[:tc.batch])

        b_run, b_res = next_batch(trainer), next_batch(resumed)
        for f in dataclasses.fields(TrainBatch):
            check(np.array_equal(getattr(b_run, f.name),
                                 getattr(b_res, f.name)),
                  f"resumed sampler draws the same {f.name}")
        s_run = trainer.train_step(b_run.to(device))
        sc.reset_launches()
        s_res = resumed.train_step(b_res.to(device))
        torch.cuda.synchronize()
        resumed_launches = dict(sc.LAUNCHES)
        expect_launches(resumed_launches, "resumed step", segsum_f32=hops,
                        segsum_f32_bwd=hops)
        for k in s_run:
            check_close(s_res[k].reshape(1), s_run[k].reshape(1),
                        RESUME_RTOL, 0.0, f"resumed step {k} vs uninterrupted")
        out["resumed_step_losses"] = {k: float(v) for k, v in s_res.items()}
        out["launches_resumed_step"] = {k: v for k, v in
                                        resumed_launches.items() if v}
        batch = b_res.to(device)
        out["profile"] = profile_steps(lambda: resumed.train_step(batch))

        # host sampling per batch on one epoch's first users, each backend
        skw = dict(batch=tc.batch, samp_num=tc.samp_num,
                   ssl_num=tc.ssl_num, pred_num=tc.pred_num,
                   pos_length=mc.pos_length, test_size=tc.test_size,
                   seed=tc.seed)
        out["host_sample_ms_by_backend"] = {}
        for backend in ("native", "numpy"):
            smp = Sampler(bundle, backend=backend, **skw)
            ids = smp.epoch_user_ids(tc.trn_num)
            t0 = time.perf_counter()
            for i in range(SAMPLE_BATCHES):
                smp.train_batch(ids[i * tc.batch:(i + 1) * tc.batch])
            out["host_sample_ms_by_backend"][backend] = (
                (time.perf_counter() - t0) / SAMPLE_BATCHES * 1e3)
        # the epoch with the numpy sampler (the run's was native)
        numpy_trainer = Trainer(run_cfg, bundle, ckpt_root=root,
                                device=device, sampler_backend="numpy")
        t0 = time.perf_counter()
        numpy_trainer.train_epoch(verbose=False)
        torch.cuda.synchronize()
        out["epoch_s_numpy"] = time.perf_counter() - t0
        out["host_sample_ms_numpy_epoch"] = (
            sum(numpy_trainer.sample_timer.times)
            / len(numpy_trainer.sample_timer.times) * 1e3)
        del numpy_trainer
    log(f"training: epoch of {steps} steps {out['epoch_s']:.2f} s, step "
        f"{out['step_ms_mean']:.2f} ms mean (p50 {out['step_ms_p50']:.2f}, "
        f"p95 {out['step_ms_p95']:.2f}) after the first, host sampling "
        f"{out['host_sample_ms']:.1f} ms per batch; preLoss "
        f"{out['first_preloss']:.4f} -> {out['last_preloss']:.4f}; save "
        f"{out['checkpoint_save_s']:.2f} s, restore "
        f"{out['checkpoint_restore_s']:.2f} s")
    by = out["host_sample_ms_by_backend"]
    log(f"sampler: native {by['native']:.1f} ms per batch, numpy "
        f"{by['numpy']:.1f} ms ({SAMPLE_BATCHES} batches each); epoch "
        f"native {out['epoch_s']:.2f} s, numpy {out['epoch_s_numpy']:.2f} s")
    return out


def _csr(ptr, cols, values, shape):
    """A torch CSR matrix over a plan's rows (the library yardsticks'
    operand), built outside any timed region."""
    import torch
    n = values.numel()
    return torch.sparse_csr_tensor(ptr.long(), cols[:n].long(), values,
                                   size=shape, check_invariants=False)


def _library_ms(what, fn, want, rtol, atol) -> float | None:
    """The yardstick's time, after holding its result against `want`; None
    (logged) where this PyTorch build cannot run it on the card. The port
    never calls it."""
    try:
        got = fn()
    except RuntimeError as e:
        log(f"  library[{what}]: not run here ({str(e).splitlines()[0]})")
        return None
    check_close(got, want, rtol, atol, f"library[{what}]")
    return kernel_ms(fn)


def _k2_bytes(n_src, n_tgt, n_edges, d, elem) -> int:
    """K2's unique bytes: the table once, the source ids, the f32 weights
    and the row pointers once, the f32 output once."""
    return (n_src * d * elem + n_edges * 4 + n_edges * 4 + (n_tgt + 1) * 4
            + n_tgt * d * 4)


def _k5_bytes(n_src, n_tgt, n_edges, slots, d) -> int:
    """K5's unique bytes: both tables once, at the 4 bytes a value that the
    call is given in both modes (bf16 mode rounds f32 tables as it reads
    them), the source and target ids of the real edges, the edge count,
    the f32 scores of every slot."""
    return ((n_src + n_tgt) * d * 4 + n_edges * 8 + 4 + slots * 4)


def _p1_bytes(x, src) -> int:
    """P1's unique bytes at run 1: the distinct rows touched once, the
    ids and the f32 [D] output."""
    import torch
    distinct = int(torch.unique(src).numel())
    return (distinct * x.shape[1] * x.element_size() + src.numel() * 4
            + x.shape[1] * 4)


def _bound_ms(nbytes, flops) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def _record(name, source, replaces, mode):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "mode": mode, "per_direction": {},
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "library_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes"}


def _add(rec, d, err, **times):
    rec["per_direction"][d] = dict(max_abs_err=err, **times)
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        if times.get(key) is None or rec[key] is None:
            rec[key] = None
        else:
            rec[key] += times[key]


def edge_kernel_phase(graphs, device) -> dict:
    """K2 and K5 against their plain versions summed in f64 (and the
    library calls) on interval 0, both directions, f32 and bf16 tables;
    K2 with the "mean" weights of each direction. Plus an empty graph and
    a graph with empty rows. Returns per-kernel records."""
    import torch
    from sagnn_tpu_torch.ops import spmm_cuda as sc

    gen = torch.Generator(device=device).manual_seed(4)
    D = 64
    records = {}
    for exact in (True, False):
        mode = "f32" if exact else "bf16"
        elem = 4 if exact else 2
        table = ("exact f32 tables" if exact
                 else "bf16 tables, f32 weights and accumulation")
        k2 = _record(f"wsegsum_{mode}", KERNEL_SOURCE, K2_REPLACES, table)
        k5 = _record(f"sddmm_{mode}", SDDMM_SOURCE, K5_REPLACES, table)
        edges = runs = 0        # the pair's, for K5's schedule line
        for d, n_src in (("u", NUM_ITEMS), ("i", NUM_USERS)):
            src, tgt = graphs[f"{d}_src"][0], graphs[f"{d}_tgt"][0]
            ptr = graphs[f"{d}_ptr"][0]
            w = graphs["edge_weights"][0 if d == "u" else 1][0]
            n_tgt, n, slots = ptr.numel() - 1, int(ptr[-1]), src.numel()
            x = torch.randn((n_src, D), generator=gen, device=device)
            y = torch.randn((n_tgt, D), generator=gen, device=device)
            xl = x if exact else x.to(torch.bfloat16).float()
            yl = y if exact else y.to(torch.bfloat16).float()
            # K2
            out = sc.spmm_weighted_apply(x, w, src, ptr, exact)
            want = sc.spmm_weighted_apply_plain(x.double(), w.double(), src,
                                                ptr, exact)
            torch.cuda.synchronize()
            rtol, atol = seg_tol(ptr, amax(x) * amax(w))
            err = check_close(out, want, rtol, atol, f"{k2['name']}[{d}]")
            check_repeatable(lambda: sc.spmm_weighted_apply(x, w, src, ptr,
                                                            exact),
                             f"{k2['name']}[{d}]")
            a = _csr(ptr, src, w[:n], (n_tgt, n_src))
            _add(k2, d, err, edges=n, max_degree=int((ptr[1:] - ptr[:-1])
                                                     .max()),
                 ms=kernel_ms(lambda: sc.spmm_weighted_apply(x, w, src, ptr,
                                                             exact)),
                 plain_ms=kernel_ms(lambda: sc.spmm_weighted_apply_plain(
                     x, w, src, ptr, exact)),
                 library_ms=_library_ms(f"{k2['name']}[{d}]",
                                        lambda: torch.sparse.mm(a, xl), want,
                                        rtol, atol),
                 bound_ms=_bound_ms(_k2_bytes(n_src, n_tgt, n, D, elem),
                                    2 * n * D))
            # K5
            s = sc.sddmm_apply(x, y, src, tgt, ptr, exact)
            want = sc.sddmm_apply_plain(x.double(), y.double(), src, tgt,
                                        ptr, exact)
            torch.cuda.synchronize()
            atol = 1e-5 * math.sqrt(D) * float(x.abs().max()
                                               * y.abs().max())
            err = check_close(s, want, 1e-5, atol, f"{k5['name']}[{d}]")
            check(not bool(s[n:].any()), f"{k5['name']}: pad slots score 0")
            check_repeatable(lambda: sc.sddmm_apply(x, y, src, tgt, ptr,
                                                    exact),
                             f"{k5['name']}[{d}]")
            pattern = _csr(ptr, src, torch.ones(n, device=device),
                           (n_tgt, n_src))
            xt = xl.T.contiguous()
            edges += n
            runs += sc.sddmm_row_loads(tgt, n)
            _add(k5, d, err, edges=n,
                 ms=kernel_ms(lambda: sc.sddmm_apply(x, y, src, tgt, ptr,
                                                     exact)),
                 plain_ms=kernel_ms(lambda: sc.sddmm_apply_plain(
                     x, y, src, tgt, ptr, exact)),
                 library_ms=_library_ms(
                     f"{k5['name']}[{d}]",
                     lambda: torch.sparse.sampled_addmm(
                         pattern, yl, xt, beta=0.0).values(),
                     want[:n], 1e-5, atol),
                 bound_ms=_bound_ms(_k5_bytes(n_src, n_tgt, n, slots, D), 2 * n * D))
        k5["cuda_kernels_per_call"] = cuda_kernels_per_call(
            lambda: sc.sddmm_apply(x, y, src, tgt, ptr, exact))
        sddmm_layout(k5, slots, D, sc._sm_count(device.index), edges, runs)
        # an empty interval (all padding) and a graph with empty rows
        x = torch.randn((300, D), generator=gen, device=device)
        y = torch.randn((128, D), generator=gen, device=device)
        ptr = torch.zeros(129, dtype=torch.int32, device=device)
        src = torch.zeros(512, dtype=torch.int32, device=device)
        tgt = torch.full((512,), 128, dtype=torch.int32, device=device)
        w = torch.rand(512, generator=gen, device=device)
        out = sc.spmm_weighted_apply(x, w, src, ptr, exact)
        s = sc.sddmm_apply(x, y, src, tgt, ptr, exact)
        torch.cuda.synchronize()
        check(out.shape == (128, D) and not bool(out.any()),
              f"{k2['name']}: empty graph must give zeros")
        check(s.shape == (512,) and not bool(s.any()),
              f"{k5['name']}: empty graph must give zeros")
        deg = torch.randint(0, 4, (1000,), generator=gen, device=device)
        deg[::2] = 0
        ptr = torch.zeros(1001, dtype=torch.int32, device=device)
        ptr[1:] = torch.cumsum(deg, 0).to(torch.int32)
        n = int(ptr[-1])
        src = torch.randint(0, 300, (n + 40,), generator=gen, device=device,
                            dtype=torch.int32)
        tgt = torch.cat([torch.repeat_interleave(
            torch.arange(1000, device=device), deg),
            torch.full((40,), 1000, device=device)]).to(torch.int32)
        w = torch.rand(n + 40, generator=gen, device=device)
        y = torch.randn((1000, D), generator=gen, device=device)
        out = sc.spmm_weighted_apply(x, w, src, ptr, exact)
        s = sc.sddmm_apply(x, y, src, tgt, ptr, exact)
        want = sc.spmm_weighted_apply_plain(x.double(), w.double(), src, ptr,
                                            exact)
        want5 = sc.sddmm_apply_plain(x.double(), y.double(), src, tgt, ptr,
                                     exact)
        torch.cuda.synchronize()
        rtol, atol = seg_tol(ptr, amax(x) * amax(w))
        err = check_close(out, want, rtol, atol, f"{k2['name']}: empty rows")
        check(not bool(out[::2].any()), f"{k2['name']}: empty rows zero")
        k2["max_abs_err"] = max(k2["max_abs_err"], err)
        atol = 1e-5 * math.sqrt(D) * float(x.abs().max() * y.abs().max())
        err = check_close(s, want5, 1e-5, atol, f"{k5['name']}: empty rows")
        k5["max_abs_err"] = max(k5["max_abs_err"], err)
        k2["tolerance"] = SEG_TOL + " (max|x| * max|w| the largest term)"
        k2["bound_counts"] = ("bytes: the table once, the source ids, the "
                              "f32 weights and the row pointers once, the "
                              "f32 output once, at 3.35e12 B/s; operations:"
                              " one multiply-add (2) per gathered value at "
                              "67e12 FLOP/s")
        k5["tolerance"] = "rtol 1e-5, atol 1e-5*sqrt(D)*max|x|*max|y|"
        k5["bound_counts"] = ("bytes: both f32 tables once (f32 in both "
                              "modes: bf16 mode rounds them as it reads), "
                              "the source and target ids of the real "
                              "edges, the f32 score of every slot; "
                              "operations: 2*D per edge")
        for rec in (k2, k5):
            records[rec["name"]] = rec
            log(f"{rec['name']}: u {rec['per_direction']['u']['ms']:.4f} ms"
                f", i {rec['per_direction']['i']['ms']:.4f} ms; plain "
                f"{rec['plain_ms']:.4f} ms; library {rec['library_ms']} ms; "
                f"bound {rec['bound_ms']:.4f} ms; max abs err "
                f"{rec['max_abs_err']:.3e}")
    return records


def edge_backward_phase(graphs, device) -> dict:
    """Both backwards on interval 0, both directions, f32 and bf16:
    `SpmmWeightedFunction` (dx: K2 on the transpose plan; dw: K5) and
    `SddmmFunction` (dx: K2 on the transpose plan; dy: K2 on the forward
    plan) through torch.autograd.grad against plain autograd in f64 (the
    plain versions of K2 and K5 differentiated by autograd). Times the
    backward launches alone (K2 for a weighted hop's dx, K5 for its dw),
    the whole autograd backwards, the plain versions and the library
    calls. Returns per-kernel records."""
    import torch
    from sagnn_tpu_torch.ops import spmm_cuda as sc

    gen = torch.Generator(device=device).manual_seed(5)
    D = 64
    records = {}
    for exact in (True, False):
        mode = "f32" if exact else "bf16"
        elem = 4 if exact else 2
        k2 = _record(f"wsegsum_{mode}_bwd", KERNEL_SOURCE, K2_BWD_REPLACES,
                     "backward: dx of a weighted hop on the transpose plan "
                     "(timed); also the SDDMM's dx and dy")
        k5 = _record(f"sddmm_{mode}_bwd", SDDMM_SOURCE, K5_BWD_REPLACES,
                     "backward: dw of a weighted hop over the forward plan")
        edges = runs = 0        # the pair's, for K5's schedule line
        for rec in (k2, k5):
            rec["autograd_ms"] = 0.0
        for d in ("u", "i"):
            o = "i" if d == "u" else "u"
            plan = (graphs[f"{d}_src"][0], graphs[f"{d}_tgt"][0],
                    graphs[f"{d}_ptr"][0], graphs[f"{o}_src"][0],
                    graphs[f"{o}_ptr"][0], graphs[f"{o}_from_{d}"][0])
            fsrc, ftgt, fptr, bsrc, bptr, to_bwd = plan
            n_x, n_t = bptr.numel() - 1, fptr.numel() - 1
            n, slots = int(fptr[-1]), fsrc.numel()
            w = graphs["edge_weights"][0 if d == "u" else 1][0].clone()
            x = torch.randn((n_x, D), generator=gen, device=device)
            y = torch.randn((n_t, D), generator=gen, device=device)
            g = torch.randn((n_t, D), generator=gen, device=device)
            gs = torch.randn(slots, generator=gen, device=device)
            xv, wv, yv = (t.clone().requires_grad_() for t in (x, w, y))
            out = sc.spmm_weighted(xv, wv, *plan, exact)
            dx, dw = torch.autograd.grad(out, (xv, wv), g, retain_graph=True)
            s = sc.sddmm(xv, yv, *plan, exact)
            dxs, dy = torch.autograd.grad(s, (xv, yv), gs, retain_graph=True)
            x64, w64, y64 = (t.double().requires_grad_() for t in (x, w, y))
            g64, gs64 = g.double(), gs.double()
            if exact:
                # plain autograd in f64: the plain versions differentiated
                ref = sc.spmm_weighted_apply_plain(x64, w64, fsrc, fptr)
                rdx, rdw = torch.autograd.grad(ref, (x64, w64), g64)
                ref = sc.sddmm_apply_plain(x64, y64, fsrc, ftgt, fptr)
                rdxs, rdy = torch.autograd.grad(ref, (x64, y64), gs64)
            else:
                # the bf16 backwards round the tables they gather (the
                # cotangent g, the saved x and y) to bf16, as JAX's do;
                # autograd through the plain versions would not round g,
                # so the reference is the plain transposes on the rounded
                # tables, summed in f64
                gs_b = gs64.index_select(0, to_bwd)
                rdx = sc.spmm_weighted_apply_plain(
                    g64, w64.detach().index_select(0, to_bwd), bsrc, bptr,
                    exact)
                rdw = sc.sddmm_apply_plain(x64, g64, fsrc, ftgt, fptr,
                                           exact)
                rdxs = sc.spmm_weighted_apply_plain(y64, gs_b, bsrc, bptr,
                                                    exact)
                rdy = sc.spmm_weighted_apply_plain(x64, gs64, fsrc, fptr,
                                                   exact)
            torch.cuda.synchronize()
            rtol, atol = seg_tol(bptr, amax(g) * amax(w))
            err2 = check_close(dx, rdx, rtol, atol,
                               f"{k2['name']}[{d}-hop dx]")
            check_repeatable(lambda: torch.autograd.grad(
                out, xv, g, retain_graph=True)[0], f"{k2['name']}[{d}-hop dx]")
            err2 = max(err2, check_close(
                dxs, rdxs, rtol, seg_tol(bptr, amax(y) * amax(gs))[1],
                f"{k2['name']}[{d}-hop sddmm dx]"))
            err2 = max(err2, check_close(
                dy, rdy, rtol, seg_tol(fptr, amax(x) * amax(gs))[1],
                f"{k2['name']}[{d}-hop sddmm dy]"))
            atol5 = 1e-5 * math.sqrt(D) * float(x.abs().max()
                                                * g.abs().max())
            err5 = check_close(dw, rdw, 1e-5, atol5,
                               f"{k5['name']}[{d}-hop dw]")
            check_repeatable(lambda: torch.autograd.grad(
                out, wv, g, retain_graph=True)[0], f"{k5['name']}[{d}-hop dw]")
            edges += n
            runs += sc.sddmm_row_loads(ftgt, n)
            w_b = w.index_select(0, to_bwd)
            gl = g if exact else g.to(torch.bfloat16).float()
            xl = x if exact else x.to(torch.bfloat16).float()
            at = _csr(bptr, bsrc, w_b[:int(bptr[-1])], (n_x, n_t))
            _add(k2, d, err2, plan=o,
                 ms=kernel_ms(lambda: sc.spmm_weighted_apply(g, w_b, bsrc,
                                                             bptr, exact)),
                 plain_ms=kernel_ms(lambda: sc.spmm_weighted_apply_plain(
                     g, w_b, bsrc, bptr, exact)),
                 library_ms=_library_ms(
                     f"{k2['name']}[{d}-hop dx]",
                     lambda: torch.sparse.mm(at, gl), rdx, rtol, atol),
                 bound_ms=_bound_ms(_k2_bytes(n_t, n_x, n, D, elem),
                                    2 * n * D))
            pattern = _csr(fptr, fsrc, torch.ones(n, device=device),
                           (n_t, n_x))
            xt = xl.T.contiguous()
            _add(k5, d, err5, plan=d,
                 ms=kernel_ms(lambda: sc.sddmm_apply(x, g, fsrc, ftgt, fptr,
                                                     exact)),
                 plain_ms=kernel_ms(lambda: sc.sddmm_apply_plain(
                     x, g, fsrc, ftgt, fptr, exact)),
                 library_ms=_library_ms(
                     f"{k5['name']}[{d}-hop dw]",
                     lambda: torch.sparse.sampled_addmm(
                         pattern, gl, xt, beta=0.0).values(),
                     rdw[:n], 1e-5, atol5),
                 bound_ms=_bound_ms(_k5_bytes(n_x, n_t, n, slots, D),
                                    2 * n * D))
            k2["autograd_ms"] += kernel_ms(lambda: torch.autograd.grad(
                out, (xv, wv), g, retain_graph=True))
            k5["autograd_ms"] += kernel_ms(lambda: torch.autograd.grad(
                s, (xv, yv), gs, retain_graph=True))
        k5["cuda_kernels_per_call"] = cuda_kernels_per_call(
            lambda: sc.sddmm_apply(x, g, fsrc, ftgt, fptr, exact))
        sddmm_layout(k5, slots, D, sc._sm_count(device.index), edges, runs)
        k2["tolerance"] = (SEG_TOL + " of the plan (the table's max|x| * "
                           "max|weight| the largest term)")
        k5["tolerance"] = "rtol 1e-5, atol 1e-5*sqrt(D)*max|x|*max|g|"
        k2["autograd"] = "autograd_ms: the whole SpmmWeightedFunction backward"
        k5["autograd"] = "autograd_ms: the whole SddmmFunction backward"
        for rec in (k2, k5):
            records[rec["name"]] = rec
            log(f"{rec['name']}: u-hop {rec['per_direction']['u']['ms']:.4f}"
                f" ms, i-hop {rec['per_direction']['i']['ms']:.4f} ms; "
                f"autograd {rec['autograd_ms']:.4f} ms; plain "
                f"{rec['plain_ms']:.4f} ms; library {rec['library_ms']} ms; "
                f"bound {rec['bound_ms']:.4f} ms; max abs err "
                f"{rec['max_abs_err']:.3e}")
    return records


def variant_serving_phase(cfg, bundle, params, device):
    """The edge variants at full width through `Recommender` (the preset
    unchanged but for the variant; the bundle and weights reused): each
    encode's launches read just after it, its node states and fused
    outputs held against the plain path (the "xla" backend for the norms,
    the plain K5/softmax/K2 for attention) with its propagation in f64;
    then one bf16 encode with edge attention, held hop by hop. Returns
    (results, {variant: launches}, {variant: Recommender})."""
    import torch
    from sagnn_tpu_torch.models import selfgnn
    from sagnn_tpu_torch.models.selfgnn import (_interval_propagation,
                                                _temporal_fusion)
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.serve import Recommender

    hops = cfg.model.graph_num * cfg.model.gnn_layer * 2
    results, launches, recs = {}, {}, {}
    for name, variant, want in (
            ("sym_sqrt", dict(edge_norm="sym_sqrt"), {"wsegsum_f32": hops}),
            ("mean", dict(edge_norm="mean"), {"wsegsum_f32": hops}),
            ("attention", dict(edge_attention=True),
             {"sddmm_f32": hops, "wsegsum_f32": hops})):
        vcfg = cfg.replace(model=dataclasses.replace(cfg.model, **variant))
        mc = vcfg.model
        t0 = time.perf_counter()
        rec = Recommender(vcfg, bundle, params, device=device)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        sc.reset_launches()
        fu, fi = rec.encode()
        torch.cuda.synchronize()
        launches[name] = dict(sc.LAUNCHES)
        log(f"{name} encode launches: {launches[name]}")
        expect_launches(launches[name], f"{name} encode", **want)
        with f64_propagation():
            uv64, iv64 = selfgnn._interval_propagation(
                rec.params, rec.graphs, mc, NUM_USERS, NUM_ITEMS)
        uv, iv = selfgnn._interval_propagation(rec.params, rec.graphs, mc,
                                               NUM_USERS, NUM_ITEMS)
        ru, ri = _temporal_fusion(rec.params, uv64, iv64, mc)
        torch.cuda.synchronize()
        prop_tol = (1e-4, 1e-5) if mc.edge_attention else (1e-5, 1e-5)
        check_close(uv, uv64, *prop_tol, f"{name} user_vec kernel vs plain")
        check_close(iv, iv64, *prop_tol, f"{name} item_vec kernel vs plain")
        err_u = check_close(fu, ru, 1e-4, 1e-5,
                            f"{name} final_user kernel vs plain")
        err_i = check_close(fi, ri, 1e-4, 1e-5,
                            f"{name} final_item kernel vs plain")
        encode_ms = cuda_ms(rec.encode, iters=5, warmup=1)
        propagation_ms = cuda_ms(
            lambda: _interval_propagation(rec.params, rec.graphs, mc,
                                          NUM_USERS, NUM_ITEMS),
            iters=5, warmup=1)
        results[name] = {"encode_ms": encode_ms,
                         "propagation_ms": propagation_ms,
                         "recommender_setup_s": setup_s,
                         "max_abs_err_final": max(err_u, err_i),
                         "launches": {k: v for k, v in launches[name].items()
                                      if v}}
        log(f"{name} encode {encode_ms:.3f} ms: propagation "
            f"{propagation_ms:.3f} ms; kernel vs plain max abs err "
            f"{max(err_u, err_i):.3e}; Recommender set-up {setup_s:.1f} s")
        recs[name] = rec

    # bf16 tables with edge attention
    att = recs["attention"]
    mc16 = dataclasses.replace(att.cfg.model, spmm_exact=False)
    rec16 = Recommender(att.cfg.replace(model=mc16), bundle, params,
                        device=device)
    sc.reset_launches()
    fu16, fi16 = rec16.encode()
    torch.cuda.synchronize()
    launches["attention_bf16"] = dict(sc.LAUNCHES)
    log(f"bf16 attention encode launches: {launches['attention_bf16']}")
    expect_launches(launches["attention_bf16"], "bf16 attention encode",
                    sddmm_bf16=hops, wsegsum_bf16=hops)
    uv16, iv16 = _interval_propagation(rec16.params, rec16.graphs, mc16,
                                       NUM_USERS, NUM_ITEMS)
    uv_ref, iv_ref = bf16_propagation_reference(
        rec16.params, rec16.graphs, mc16, NUM_USERS, NUM_ITEMS,
        attr="attention_propagate")
    ru16, ri16 = _temporal_fusion(rec16.params, uv_ref.float(),
                                  iv_ref.float(), mc16)
    torch.cuda.synchronize()
    check_close(uv16, uv_ref, 1e-4, 1e-5, "bf16 attention user_vec")
    check_close(iv16, iv_ref, 1e-4, 1e-5, "bf16 attention item_vec")
    err_u = check_close(fu16, ru16, 1e-4, 1e-5,
                        "bf16 attention final_user kernel vs plain")
    err_i = check_close(fi16, ri16, 1e-4, 1e-5,
                        "bf16 attention final_item kernel vs plain")
    fu32, fi32 = att.encodings
    dev16 = max(max_err(fu16, fu32), max_err(fi16, fi32))
    results["attention_bf16"] = {
        "encode_ms": cuda_ms(rec16.encode, iters=5, warmup=1),
        "max_abs_err_final": max(err_u, err_i),
        "max_abs_dev_from_f32_encode": dev16,
        "launches": {k: v for k, v in launches["attention_bf16"].items()
                     if v}}
    log(f"bf16 attention encode {results['attention_bf16']['encode_ms']:.3f}"
        f" ms; max abs deviation from the f32 attention encode {dev16:.3e}")
    return results, launches, recs


def variant_step_phase(cfg, bundle, params, batch, recs, device) -> dict:
    """One full-width training step (keepRate 1, the batch of the parity
    step) per variant, the kernel path against the plain path with its
    propagation in f64 (losses and every gradient at the parity step's
    tolerances), with the launch counts read around it: edge_norm="mean",
    edge attention, edge_dropout_keep=0.8 (one mask drawn on the card
    from one generator state, given to both sides), and edge attention on
    bf16 tables (losses near the f32 step's). Logs each step's device time
    and its propagation part."""
    import torch
    from sagnn_tpu_torch.models import selfgnn
    from sagnn_tpu_torch.ops import spmm_cuda as sc

    tc = cfg.train
    nu, ni = bundle.num_users, bundle.num_items
    hops = cfg.model.graph_num * cfg.model.gnn_layer * 2
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    out = {}
    steps = (
        ("mean", dict(edge_norm="mean"), recs["mean"].graphs,
         dict(wsegsum_f32=hops, wsegsum_f32_bwd=hops)),
        ("attention", dict(edge_attention=True), recs["attention"].graphs,
         dict(sddmm_f32=hops, sddmm_f32_bwd=hops, wsegsum_f32=hops,
              wsegsum_f32_bwd=3 * hops)),
        ("dropout", dict(edge_dropout_keep=0.8), recs["attention"].graphs,
         dict(wsegsum_f32=hops, wsegsum_f32_bwd=hops)),
        ("attention_bf16", dict(edge_attention=True, spmm_exact=False),
         recs["attention"].graphs,
         dict(sddmm_bf16=hops, sddmm_bf16_bwd=hops, wsegsum_bf16=hops,
              wsegsum_bf16_bwd=3 * hops)))
    for name, variant, graphs, want in steps:
        mc = dataclasses.replace(cfg.model, keep_rate=1.0, **variant)
        kernel = selfgnn.SelfGNN(mc, nu, ni)
        gen = torch.Generator(device=device).manual_seed(11)
        state = gen.get_state()
        kinks = []
        sc.reset_launches()
        with kernel_kinks(kinks):
            got = loss_and_grads(kernel, leaves, graphs, batch, tc, gen)
        torch.cuda.synchronize()
        launches = dict(sc.LAUNCHES)
        log(f"{name} train step launches: {launches}")
        expect_launches(launches, f"{name} train step", **want)
        rec = {"launches_per_step": {k: v for k, v in launches.items()
                                     if v}}
        if name == "attention_bf16":
            f32 = out["attention"]["_losses"]
            check_close(got[0].reshape(1), f32[0].reshape(1), BF16_LOSS_RTOL,
                        0.0, "bf16 attention step preLoss vs f32")
            check_close(got[1].reshape(1), f32[1].reshape(1), BF16_LOSS_RTOL,
                        0.0, "bf16 attention step sslloss vs f32")
            check(all(bool(torch.isfinite(g).all())
                      for g in got[2].values()),
                  "bf16 attention step gradients finite")
        else:
            gen.set_state(state)        # the same edge-dropout mask
            with f64_propagation(kinks):
                ref = loss_and_grads(kernel, leaves, graphs, batch, tc, gen)
            torch.cuda.synchronize()
            share, worst = check_step(got, ref, f"{name} step")
            rec.update(grad_check_share=share, grad_check_worst=worst)
            rec["_losses"] = got[:2]

        def prop():
            weights = None
            if mc.edge_dropout_keep < 1.0:
                gen.set_state(state)
                weights = selfgnn.edge_dropout(graphs, mc, gen)
            return selfgnn._interval_propagation(leaves, graphs, mc, nu, ni,
                                                 weights)

        def step():
            gen.set_state(state)
            return loss_and_grads(kernel, leaves, graphs, batch, tc, gen)

        uv, iv = prop()
        cu, ci = torch.randn_like(uv), torch.randn_like(iv)
        uk, ik = leaves["reg/u_embed"], leaves["reg/i_embed"]
        rec["step_ms"] = cuda_ms(step, iters=3, warmup=1)
        rec["propagation_fwd_ms"] = cuda_ms(prop, iters=3, warmup=1)
        rec["propagation_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            list(prop()), [uk, ik], [cu, ci]), iters=3, warmup=1) \
            - rec["propagation_fwd_ms"]
        log(f"{name} train step {rec['step_ms']:.3f} ms (forward + "
            f"backward): propagation {rec['propagation_fwd_ms']:.3f} + "
            f"{rec['propagation_bwd_ms']:.3f} ms")
        out[name] = rec
    for rec in out.values():
        rec.pop("_losses", None)
    return out


def variant_training_phase(cfg, bundle, device) -> dict:
    """`Trainer.run()` for one epoch with edge attention and its
    evaluations, launches counted over the run; then a Trainer with
    edge_norm="sym_sqrt" and edge_dropout_keep=0.8 trains one epoch,
    checkpoints, and a second Trainer resumes from the checkpoint: the
    next step on each, from the same batch and dropout state, agrees."""
    import numpy as np
    import torch
    from sagnn_tpu_torch.models.selfgnn import TrainBatch
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.train.trainer import Trainer
    from sagnn_tpu_torch.utils.profiling import StepTimer

    tc = cfg.train
    hops = cfg.model.graph_num * cfg.model.gnn_layer * 2
    steps = -(-tc.trn_num // tc.batch)
    out = {}
    with tempfile.TemporaryDirectory() as root:
        att_cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, edge_attention=True),
            train=dataclasses.replace(tc, epoch=1, tst_epoch=1,
                                      save_path="attention"))
        trainer = Trainer(att_cfg, bundle, ckpt_root=root, device=device)
        sc.reset_launches()
        t0 = time.perf_counter()
        best = trainer.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(sc.LAUNCHES)
        log(f"attention training run launches: {launches}")
        check(trainer.state["step"] == steps, f"one epoch of {steps} steps")
        # per step 12 + 12 K5 and 12 + 36 K2; per evaluation (the epoch's
        # and the final one) 12 of each
        expect_launches(launches, "attention training run",
                        sddmm_f32=hops * (steps + 2),
                        sddmm_f32_bwd=hops * steps,
                        wsegsum_f32=hops * (steps + 2),
                        wsegsum_f32_bwd=3 * hops * steps)
        stats = trainer.step_stats
        check(all(math.isfinite(s[k]) for s in stats for k in s),
              "every attention training loss finite")
        for k, v in best.items():
            check(math.isfinite(v) and 0.0 <= v <= 1.0, f"metric {k}={v}")
        times = StepTimer(times=trainer.step_timer.times[1:])
        out["attention"] = {
            "run_s": run_s, "steps": steps,
            "step_ms_mean": times.mean * 1e3,
            "step_ms_p50": times.percentile(50) * 1e3,
            "first_preloss": stats[0]["preLoss"],
            "last_preloss": stats[-1]["preLoss"],
            "metrics": {k: best[k] for k in ("HR", "NDCG")},
            "launches_run": {k: v for k, v in launches.items() if v}}
        log(f"attention training: run {run_s:.2f} s (one epoch of {steps} "
            f"steps and two evaluations), step {times.mean * 1e3:.2f} ms "
            f"mean; preLoss {stats[0]['preLoss']:.4f} -> "
            f"{stats[-1]['preLoss']:.4f}; HR {best['HR']:.4f}")

        sd_cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, edge_norm="sym_sqrt",
                                      edge_dropout_keep=0.8),
            train=dataclasses.replace(tc, epoch=1, save_path="dropout"))
        trainer = Trainer(sd_cfg, bundle, ckpt_root=root, device=device)
        sc.reset_launches()
        t0 = time.perf_counter()
        trainer.train_epoch(verbose=False)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = dict(sc.LAUNCHES)
        expect_launches(launches, "sym_sqrt + dropout epoch",
                        wsegsum_f32=hops * steps,
                        wsegsum_f32_bwd=hops * steps)
        check(all(math.isfinite(s[k]) for s in trainer.step_stats
                  for k in s), "every dropout training loss finite")
        trainer.ckpt.save(trainer.state, trainer.history, trainer.cfg,
                          rng_state=trainer.capture_rng_state(1))
        resumed = Trainer(sd_cfg.replace(train=dataclasses.replace(
            sd_cfg.train, epoch=2, load_model="dropout")), bundle,
            ckpt_root=root, device=device)
        check(resumed.restore_checkpoint() == 1
              and resumed.state["step"] == steps,
              "dropout run restored at epoch 1")

        def next_batch(tr):
            ids = tr.sampler.epoch_user_ids(tc.trn_num)
            return tr.sampler.train_batch(ids[:tc.batch])

        b_run, b_res = next_batch(trainer), next_batch(resumed)
        for f in dataclasses.fields(TrainBatch):
            check(np.array_equal(getattr(b_run, f.name),
                                 getattr(b_res, f.name)),
                  f"dropout resume draws the same {f.name}")
        s_run = trainer.train_step(b_run.to(device))
        sc.reset_launches()
        s_res = resumed.train_step(b_res.to(device))
        torch.cuda.synchronize()
        expect_launches(dict(sc.LAUNCHES), "resumed dropout step",
                        wsegsum_f32=hops, wsegsum_f32_bwd=hops)
        for k in s_run:
            check_close(s_res[k].reshape(1), s_run[k].reshape(1),
                        RESUME_RTOL, 0.0,
                        f"resumed dropout step {k} vs uninterrupted")
        out["sym_sqrt_dropout"] = {
            "epoch_s": epoch_s, "steps": steps,
            "launches_epoch": {k: v for k, v in launches.items() if v},
            "resumed_step_losses": {k: float(v) for k, v in s_res.items()},
            "uninterrupted_step_losses": {k: float(v)
                                          for k, v in s_run.items()}}
        log(f"sym_sqrt + dropout training: epoch of {steps} steps "
            f"{epoch_s:.2f} s; resumed step losses "
            f"{out['sym_sqrt_dropout']['resumed_step_losses']}")
    return out


# the ring backend (K6) on a one-card mesh: four model ranks, all on the
# card (NCCL refuses two ranks on one card; one process drives the ring);
# K6 is _segsum_pallas(zero_init, weights) per ring bucket, its backward the
# custom VJP's ring on the transpose plans
RING_MODEL = 4
K6_SOURCE = KERNEL_SOURCE
K6_REPLACES = "sagnn_tpu/parallel/edge_partition.py:440"   # per-bucket call
K6_BWD_REPLACES = "sagnn_tpu/parallel/edge_partition.py:507"  # _ring_pl_bwd


def _ring_bytes_and_ops(plan, n_edges, d, weighted):
    """K6's bytes for one ring hop of interval 0, counted from the plan:
    what the hop must move, each source block read once, the ids (and f32
    weights), the P² row-pointer arrays, and each f32 output row written
    once; operations: one add (weighted: a multiply-add) per gathered
    value. Also the bytes the ring's schedule adds on top (not part of the
    bound; beside ms): a read and a write of the f32 output
    row for every (bucket, row) pair with edges, and each rank's P − 1
    block copies (a read and a write each). Returns (bytes, operations,
    touched (bucket, row) pairs, schedule bytes)."""
    P = plan.num_shards
    touched = sum(int((plan.ptr[p][0, :, 1:] > plan.ptr[p][0, :, :-1]).sum())
                  for p in range(P))
    nbytes = (P * plan.src_rows * d * 4 + n_edges * 4 * (2 if weighted else 1)
              + P * P * (plan.rows + 1) * 4 + P * plan.rows * d * 4)
    schedule = (touched * 2 * d * 4
                + 2 * P * (P - 1) * plan.src_rows * d * 4)
    ops = n_edges * d * (2 if weighted else 1)
    return nbytes, ops, touched, schedule


def _ring_serial_items(plan, d) -> int:
    """`serial_items` over the P² K6 launches of a hop on interval 0 (on
    one card they run one after another): the row ends and edges one warp
    walks in series in the whole hop."""
    return serial_items([plan.ptr[p][0, q] for p in range(plan.num_shards)
                         for q in range(plan.num_shards)],
                        plan.src[0].shape[-1], d)


def _ring_profile(hop) -> tuple[float | None, float]:
    """(the K6 launches' share, the block copies') of a ring hop's device
    work per call, from the profiler over 10 calls (`profiled_ms`); (None,
    0) where it saw no device events."""
    _wall, by_name = profiled_ms(hop, 10)
    if not by_name:
        return None, 0.0
    return (sum(v for k, v in by_name.items()
                if "segsum_pieces_kernel" in k),
            sum(v for k, v in by_name.items() if "Memcpy" in k))


def ring_kernel_phase(plans, graphs, sym_graphs, mesh, device) -> dict:
    """K6 on interval 0, both directions, unweighted and sym_sqrt-weighted:
    each ring hop (`ring_spmm_apply`) against its plain version
    (`ring_spmm_apply_plain`) summed in f64 and against the unsharded K1 /
    K2 sum of the same hop; its backward (`ring_spmm`, the ring on the
    transpose plan) against the plain transpose ring in f64. Times the
    ring hop, its plain version, K1/K2 and the library call
    (torch.sparse.mm on the hop's whole CSR) on the same hop. Returns
    per-kernel records. `ms` is the hop's device time (`kernel_ms`: its
    16 K6 launches and its copies); `hop_ms` the hop as called, with CUDA
    events, which the host's launch cost paces."""
    import torch
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.parallel import edge_partition as ep

    gen = torch.Generator(device=device).manual_seed(14)
    D = 64
    records = {}
    for norm, name, whole in ((None, "ring_segsum_f32", graphs),
                              ("sym_sqrt", "ring_wsegsum_f32", sym_graphs)):
        weighted = norm is not None
        ring = plans[norm]
        mode = ("sym_sqrt bucket weights, " if weighted else "") + \
            f"accumulate per ring bucket, {RING_MODEL} ranks on one card"
        fw = _record(name, K6_SOURCE, K6_REPLACES, mode)
        bw = _record(name + "_bwd", K6_SOURCE, K6_BWD_REPLACES,
                     "backward: dx, the ring on the transpose plan; " + mode)
        for rec in (fw, bw):
            rec["k12_ms"] = 0.0
        for d, n_src, n_tgt in (("u", NUM_ITEMS, NUM_USERS),
                                ("i", NUM_USERS, NUM_ITEMS)):
            o = "i" if d == "u" else "u"
            fwd, bwd = ring[d], ring[o]
            src, ptr = whole[f"{d}_src"][0], whole[f"{d}_ptr"][0]
            bsrc, bptr = whole[f"{o}_src"][0], whole[f"{o}_ptr"][0]
            n = int(ptr[-1])
            w = bw_ = None
            if weighted:
                w = whole["edge_weights"][0 if d == "u" else 1][0]
                bw_ = whole["edge_weights"][1 if d == "u" else 0][0]
            wmax = amax(w) if weighted else 1.0
            x = torch.randn((n_src, D), generator=gen, device=device)
            g = torch.randn((n_tgt, D), generator=gen, device=device)
            xb = ep.shard(x, fwd.src_rows, mesh)
            gb = ep.shard(g, fwd.rows, mesh)
            got = ep.unshard(ep.ring_spmm_apply(xb, fwd, 0, mesh), n_tgt,
                             device)
            want = ep.unshard(ep.ring_spmm_apply_plain(
                ep.shard(x.double(), fwd.src_rows, mesh), fwd, 0, mesh),
                n_tgt, device)
            if weighted:
                k12 = sc.spmm_weighted_apply(x, w, src, ptr)
            else:
                k12 = sc.spmm_apply(x, src, ptr)
            xv = [b.clone().requires_grad_() for b in xb]
            dx = torch.autograd.grad(ep.ring_spmm(xv, fwd, bwd, 0, mesh),
                                     xv, gb)
            dx = ep.unshard(list(dx), n_src, device)
            want_dx = ep.unshard(ep.ring_spmm_apply_plain(
                ep.shard(g.double(), bwd.src_rows, mesh), bwd, 0, mesh),
                n_src, device)
            torch.cuda.synchronize()
            rtol, atol = seg_tol(ptr, amax(x) * wmax)
            err = check_close(got, want, rtol, atol, f"{name}[{d}]")
            # K1/K2 and the ring both carry their own f32 rounding
            check_close(got, k12, rtol, 2 * atol,
                        f"{name}[{d}] vs the unsharded K1/K2 sum")
            brtol, batol = seg_tol(bptr, amax(g) * wmax)
            berr = check_close(dx, want_dx, brtol, batol,
                               f"{name}_bwd[{d}-hop dx]")
            check_repeatable(lambda: torch.cat(ep.ring_spmm_apply(
                xb, fwd, 0, mesh)), f"{name}[{d}]")
            check_repeatable(lambda: torch.cat(ep.ring_spmm_apply(
                ep.shard(g, bwd.src_rows, mesh), bwd, 0, mesh,
                backward=True)), f"{name}_bwd[{d}-hop dx]")
            values = w[:n] if weighted else torch.ones(n, device=device)
            a = _csr(ptr, src, values, (n_tgt, n_src))
            bn = int(bptr[-1])
            bvalues = bw_[:bn] if weighted else torch.ones(bn, device=device)
            at = _csr(bptr, bsrc, bvalues, (n_src, n_tgt))
            nbytes, ops, touched, sched = _ring_bytes_and_ops(fwd, n, D,
                                                              weighted)
            bbytes, bops, btouched, bsched = _ring_bytes_and_ops(bwd, n, D,
                                                                 weighted)
            if weighted:
                k12_ms = kernel_ms(lambda: sc.spmm_weighted_apply(
                    x, w, src, ptr))
                bk12_ms = kernel_ms(lambda: sc.spmm_weighted_apply(
                    g, bw_, bsrc, bptr))
            else:
                k12_ms = kernel_ms(lambda: sc.spmm_apply(x, src, ptr))
                bk12_ms = kernel_ms(lambda: sc.spmm_apply(g, bsrc, bptr))
            gbb = ep.shard(g, bwd.src_rows, mesh)
            times = {}
            for key, hop in (
                    ("fw", lambda: ep.ring_spmm_apply(xb, fwd, 0, mesh)),
                    ("bw", lambda: ep.ring_spmm_apply(gbb, bwd, 0, mesh,
                                                      backward=True))):
                k6_ms, copy_ms = _ring_profile(hop)
                times[key] = dict(ms=kernel_ms(hop), hop_ms=cuda_ms(hop),
                                  k6_profiled_ms=k6_ms, copy_ms=copy_ms)
            _add(fw, d, err, edges=n, touched_bucket_rows=touched,
                 serial_items=_ring_serial_items(fwd, D),
                 k12_serial_items=serial_items([ptr], src.numel(), D),
                 unique_bytes=nbytes, schedule_bytes=sched,
                 k12_ms=k12_ms, **times["fw"],
                 plain_ms=kernel_ms(lambda: ep.ring_spmm_apply_plain(
                     xb, fwd, 0, mesh), iters=5),
                 library_ms=_library_ms(f"{name}[{d}]",
                                        lambda: torch.sparse.mm(a, x),
                                        got, rtol, 2 * atol),
                 bound_ms=_bound_ms(nbytes, ops))
            _add(bw, d, berr, plan=o, edges=n, touched_bucket_rows=btouched,
                 serial_items=_ring_serial_items(bwd, D),
                 k12_serial_items=serial_items([bptr], bsrc.numel(), D),
                 unique_bytes=bbytes, schedule_bytes=bsched,
                 k12_ms=bk12_ms, **times["bw"],
                 plain_ms=kernel_ms(lambda: ep.ring_spmm_apply_plain(
                     gbb, bwd, 0, mesh), iters=5),
                 library_ms=kernel_ms(lambda: torch.sparse.mm(at, g)),
                 bound_ms=_bound_ms(bbytes, bops))
        for rec in (fw, bw):
            for key in ("k12_ms", "hop_ms", "k6_profiled_ms", "copy_ms",
                        "unique_bytes", "schedule_bytes"):
                rec[key] = sum(v[key] or 0.0
                               for v in rec["per_direction"].values())
            rec["ms_measured"] = (
                "ms: the ring hop's device time (its 16 K6 launches, block "
                "copies and zero fills; profiling.device_ms, mean of 20); "
                "hop_ms: the hop as called (CUDA events, mean of 20), paced "
                "by the host; k6_profiled_ms, copy_ms: the K6 launches' and "
                "the copies' device time by torch.profiler (10 hops)")
            rec["tolerance"] = SEG_TOL + " of the hop's whole CSR (max|x| * "
            rec["tolerance"] += "max|weight| the largest term)" if weighted \
                else "1)"
            rec["bound_counts"] = (
                "each source block read once, the ids (and f32 weights), "
                "the P^2 row-pointer arrays and each f32 output row written "
                "once, at 3.35e12 B/s; operations: one f32 add (weighted: "
                "multiply-add) per gathered value at 67e12 FLOP/s. "
                "schedule_bytes, not in the bound: what the ring adds, a "
                "read and a write of the output row per (bucket, row) pair "
                "with edges and of each of the P(P-1) block copies")
            records[rec["name"]] = rec
            log(f"{rec['name']}: u {rec['per_direction']['u']['ms']:.4f}"
                f" ms, i {rec['per_direction']['i']['ms']:.4f} ms of device "
                f"time; the hops as called {rec['hop_ms']:.4f} ms (profiled:"
                f" K6 {rec['k6_profiled_ms']:.4f} ms, copies "
                f"{rec['copy_ms']:.4f} ms); K1/K2 {rec['k12_ms']:.4f} ms; "
                f"plain {rec['plain_ms']:.4f} ms; library "
                f"{rec['library_ms']} ms; bound {rec['bound_ms']:.4f} ms; "
                f"max abs err {rec['max_abs_err']:.3e}; items one warp "
                "walks in series "
                + ", ".join(f"{d} {v['serial_items']} (K1/K2 "
                            f"{v['k12_serial_items']})"
                            for d, v in rec["per_direction"].items()))
    return records


def _ring_hop_kinks(kinks: list, model_ranks: int) -> list:
    """The ring path's recorded kinks, one per block, as one mask per hop
    (the blocks of a hop laid end to end), for a replay on a path that
    takes each hop whole; the replay slices off the pad rows."""
    import torch
    return [torch.cat(kinks[i:i + model_ranks])
            for i in range(0, len(kinks), model_ranks)]


def ring_phase(cfg, bundle, params, batch, rec, vrecs, device):
    """The ring backend at the preset's full width on a one-card mesh of
    RING_MODEL ranks: K6 against its plain version
    (`ring_kernel_phase`); the ring encode (192 K6 launches, no K1)
    against the "pallas" encode on the same weights and against the plain
    propagation in f64; one keepRate-1 step against the "pallas" step
    (192 + 192 launches; each hop's leaky-relu on the ring's side of the
    kink); the sym_sqrt encode and step (`ring_wsegsum_f32`) and the
    'mean' encode (no K6 launch) against the plain path in f64;
    `Trainer(mesh=...).run()` for one epoch with its evaluations and a
    checkpoint, restored into a "pallas" Trainer bit for bit. Returns
    (results, records)."""
    import torch
    from sagnn_tpu_torch.data.graph import compile_interval_graphs, \
        edge_weights
    from sagnn_tpu_torch.models import selfgnn
    from sagnn_tpu_torch.models.selfgnn import _temporal_fusion
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.parallel.edge_partition import ring_graphs
    from sagnn_tpu_torch.parallel.mesh import make_mesh
    from sagnn_tpu_torch.train.trainer import Trainer

    tc = cfg.train
    mesh = make_mesh(model=RING_MODEL, devices=[device] * RING_MODEL)
    mc = dataclasses.replace(cfg.model, spmm_backend="ring")
    per_hop = RING_MODEL * RING_MODEL
    launches_per_encode = mc.graph_num * mc.gnn_layer * 2 * per_hop
    out = {"mesh": {"data": 1, "model": RING_MODEL,
                    "devices": [str(dv) for dv in mesh.model_devices]},
           "launches": {}}
    t0 = time.perf_counter()
    gb = compile_interval_graphs(bundle.sub_mats)
    plans = {norm: ring_graphs(gb, mesh, None if norm is None else
                               edge_weights(gb, bundle.sub_mats, norm))
             for norm in (None, "sym_sqrt", "mean")}
    torch.cuda.synchronize()
    out["plans_s"] = time.perf_counter() - t0
    pu = plans[None]["u"]
    out["rows_u"], out["rows_i"] = pu.rows, pu.src_rows
    out["bucket_edges"] = {d: [[int(plans[None][d].ptr[p][0, q, -1])
                                for q in range(RING_MODEL)]
                               for p in range(RING_MODEL)]
                           for d in ("u", "i")}
    log(f"ring plans: {out['plans_s']:.1f} s; rows_u {pu.rows}, rows_i "
        f"{pu.src_rows}; interval-0 u-bucket edges "
        f"{out['bucket_edges']['u']}")

    records = ring_kernel_phase(plans, rec.graphs, vrecs["sym_sqrt"].graphs,
                                mesh, device)

    # the ring encode against the "pallas" encode and the plain f64 path
    model = selfgnn.SelfGNN(mc, NUM_USERS, NUM_ITEMS, mesh=mesh)
    graphs = {"ring": plans[None]}
    sc.reset_launches()
    fu, fi, uv, iv = model.encode(params, graphs)
    torch.cuda.synchronize()
    launches = dict(sc.LAUNCHES)
    out["launches"]["encode"] = {k: v for k, v in launches.items() if v}
    log(f"ring encode launches: {out['launches']['encode']}")
    expect_launches(launches, "ring encode",
                    ring_segsum_f32=launches_per_encode)
    pfu, pfi = rec.encodings
    for name, got, want in (("final_user", fu, pfu), ("final_item", fi, pfi)):
        check_close(got, want, 1e-4, 1e-5 * amax(want),
                    f"ring {name} vs pallas")
    with f64_propagation():
        uv64, iv64 = selfgnn._interval_propagation(
            params, graphs, mc, NUM_USERS, NUM_ITEMS, mesh=mesh)
    ru, ri = _temporal_fusion(params, uv64, iv64, mc)
    torch.cuda.synchronize()
    check_close(uv, uv64, 1e-5, 1e-5, "ring user_vec vs plain f64")
    check_close(iv, iv64, 1e-5, 1e-5, "ring item_vec vs plain f64")
    err = max(check_close(fu, ru, 1e-4, 1e-5, "ring final_user vs plain"),
              check_close(fi, ri, 1e-4, 1e-5, "ring final_item vs plain"))
    out["encode_ms"] = cuda_ms(lambda: model.encode(params, graphs), iters=5,
                               warmup=1)
    out["propagation_ms"] = cuda_ms(
        lambda: selfgnn._interval_propagation(params, graphs, mc, NUM_USERS,
                                              NUM_ITEMS, mesh=mesh),
        iters=5, warmup=1)
    out["max_abs_err_final"] = err
    wall, by_name = profiled_ms(lambda: model.encode(params, graphs), 3)
    busy = sum(by_name.values())
    out["encode_profile"] = {
        "wall_ms": wall, "device_ms": busy if by_name else None,
        "busy_share": busy / wall if by_name else None,
        "k6_ms": sum(v for k, v in by_name.items()
                     if "segsum_pieces_kernel" in k),
        "copy_ms": sum(v for k, v in by_name.items() if "Memcpy" in k)}
    log(f"ring encode {out['encode_ms']:.3f} ms: propagation "
        f"{out['propagation_ms']:.3f} ms; profiled: {out['encode_profile']}")

    # one keepRate-1 step against the "pallas" step
    mc1 = dataclasses.replace(mc, keep_rate=1.0)
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    ring1 = selfgnn.SelfGNN(mc1, NUM_USERS, NUM_ITEMS, mesh=mesh)
    kinks = []
    sc.reset_launches()
    with kernel_kinks(kinks):
        got = loss_and_grads(ring1, leaves, graphs, batch, tc)
    torch.cuda.synchronize()
    launches = dict(sc.LAUNCHES)
    out["launches"]["step"] = {k: v for k, v in launches.items() if v}
    log(f"ring step launches: {out['launches']['step']}")
    expect_launches(launches, "ring step",
                    ring_segsum_f32=launches_per_encode,
                    ring_segsum_f32_bwd=launches_per_encode)
    hop_kinks = _ring_hop_kinks(kinks, RING_MODEL)

    def replay(x, leaky):
        return torch.where(hop_kinks.pop(0)[:x.shape[0]], x, leaky * x)

    pallas1 = selfgnn.SelfGNN(dataclasses.replace(mc1, spmm_backend="pallas"),
                              NUM_USERS, NUM_ITEMS)
    with _hop_relu(replay):
        want = loss_and_grads(pallas1, leaves, rec.graphs, batch, tc)
    torch.cuda.synchronize()
    check(not hop_kinks, "every ring hop replayed on the pallas step")
    share, worst = check_step(got, want, "ring step vs pallas")
    out["step_grad_check_share"], out["step_grad_check_worst"] = share, worst
    out["step_ms"] = cuda_ms(
        lambda: loss_and_grads(ring1, leaves, graphs, batch, tc), iters=3,
        warmup=1)
    out["pallas_step_ms"] = cuda_ms(
        lambda: loss_and_grads(pallas1, leaves, rec.graphs, batch, tc),
        iters=3, warmup=1)
    log(f"ring step {out['step_ms']:.3f} ms, pallas step "
        f"{out['pallas_step_ms']:.3f} ms (forward + backward)")
    del got, want

    # sym_sqrt (K6 weighted) and 'mean' (the plain ring, no K6)
    for norm, kernel in (("sym_sqrt", "ring_wsegsum_f32"), ("mean", None)):
        vmc = dataclasses.replace(mc, edge_norm=norm)
        vmodel = selfgnn.SelfGNN(vmc, NUM_USERS, NUM_ITEMS, mesh=mesh)
        vgraphs = {"ring": plans[norm]}
        sc.reset_launches()
        vfu, vfi, vuv, viv = vmodel.encode(params, vgraphs)
        torch.cuda.synchronize()
        launches = dict(sc.LAUNCHES)
        out["launches"][f"{norm}_encode"] = {k: v for k, v in
                                             launches.items() if v}
        expect_launches(launches, f"ring {norm} encode",
                        **({kernel: launches_per_encode} if kernel else {}))
        with f64_propagation():
            uv64, iv64 = selfgnn._interval_propagation(
                params, vgraphs, vmc, NUM_USERS, NUM_ITEMS, mesh=mesh)
        ru, ri = _temporal_fusion(params, uv64, iv64, vmc)
        torch.cuda.synchronize()
        check_close(vuv, uv64, 1e-5, 1e-5, f"ring {norm} user_vec vs f64")
        check_close(viv, iv64, 1e-5, 1e-5, f"ring {norm} item_vec vs f64")
        check_close(vfu, ru, 1e-4, 1e-5, f"ring {norm} final_user vs plain")
        check_close(vfi, ri, 1e-4, 1e-5, f"ring {norm} final_item vs plain")
        out[f"{norm}_encode_ms"] = cuda_ms(
            lambda: vmodel.encode(params, vgraphs), iters=3, warmup=1)
        log(f"ring {norm} encode {out[f'{norm}_encode_ms']:.3f} ms; "
            f"launches {out['launches'][f'{norm}_encode']}")
        if kernel is None:
            continue
        vstep = selfgnn.SelfGNN(dataclasses.replace(vmc, keep_rate=1.0),
                                NUM_USERS, NUM_ITEMS, mesh=mesh)
        kinks = []
        sc.reset_launches()
        with kernel_kinks(kinks):
            got = loss_and_grads(vstep, leaves, vgraphs, batch, tc)
        torch.cuda.synchronize()
        launches = dict(sc.LAUNCHES)
        out["launches"][f"{norm}_step"] = {k: v for k, v in
                                           launches.items() if v}
        expect_launches(launches, f"ring {norm} step",
                        **{kernel: launches_per_encode,
                           kernel + "_bwd": launches_per_encode})
        with f64_propagation(kinks):
            want = loss_and_grads(vstep, leaves, vgraphs, batch, tc)
        torch.cuda.synchronize()
        out[f"{norm}_step_grad_check_share"] = check_step(
            got, want, f"ring {norm} step")[0]
        del got, want

    # Trainer(mesh=...).run(): one epoch, its evaluations, a checkpoint
    # restored into a "pallas" Trainer
    steps = -(-tc.trn_num // tc.batch)
    run_cfg = cfg.replace(model=mc, train=dataclasses.replace(
        tc, epoch=1, tst_epoch=1, save_path="ring"))
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        trainer = Trainer(run_cfg, bundle, ckpt_root=root, mesh=mesh)
        out["trainer_init_s"] = time.perf_counter() - t0
        sc.reset_launches()
        t0 = time.perf_counter()
        best = trainer.run()
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t0
        launches = dict(sc.LAUNCHES)
        out["launches"]["trainer_run"] = {k: v for k, v in launches.items()
                                          if v}
        log(f"ring training run launches: {out['launches']['trainer_run']}")
        check(trainer.state["step"] == steps, f"one epoch of {steps} steps")
        # per step 192 + 192; per evaluation (the epoch's and the final) 192
        expect_launches(launches, "ring training run",
                        ring_segsum_f32=launches_per_encode * (steps + 2),
                        ring_segsum_f32_bwd=launches_per_encode * steps)
        stats = trainer.step_stats
        check(all(math.isfinite(s[k]) for s in stats for k in s),
              "every ring training loss finite")
        for k, v in best.items():
            check(math.isfinite(v) and 0.0 <= v <= 1.0, f"metric {k}={v}")
        trainer.ckpt.save(trainer.state, trainer.history, trainer.cfg,
                          rng_state=trainer.capture_rng_state(1))
        pallas_cfg = run_cfg.replace(
            model=dataclasses.replace(mc, spmm_backend="pallas"),
            train=dataclasses.replace(run_cfg.train, epoch=2,
                                      load_model="ring"))
        back = Trainer(pallas_cfg, bundle, ckpt_root=root, device=device)
        check(back.restore_checkpoint() == 1
              and back.state["step"] == steps
              and back.state["opt_state"].count == steps,
              "ring checkpoint restored into a pallas Trainer at epoch 1")
        for k, v in trainer.state["params"].items():
            check(torch.equal(back.state["params"][k], v),
                  f"restored param {k} bit for bit")
        for part in ("mu", "nu"):
            for k, v in getattr(trainer.state["opt_state"], part).items():
                check(torch.equal(getattr(back.state["opt_state"], part)[k],
                                  v), f"restored Adam {part} {k}")
        times = trainer.step_timer.times[1:]
        out.update(steps=steps, step_ms_mean=sum(times) / len(times) * 1e3,
                   first_preloss=stats[0]["preLoss"],
                   last_preloss=stats[-1]["preLoss"],
                   metrics={k: best[k] for k in ("HR", "NDCG")})
    log(f"ring training: run {out['run_s']:.2f} s (one epoch of {steps} "
        f"steps and two evaluations), step {out['step_ms_mean']:.2f} ms "
        f"mean after the first; preLoss {out['first_preloss']:.4f} -> "
        f"{out['last_preloss']:.4f}; checkpoint restored into pallas")
    return out, records


def flagship_config():
    """scripts/bench_1m.py's exact_b512 recipe on the "pallas" backend,
    spmm_src_shard_rows left at 0 (auto)."""
    from sagnn_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                        TrainConfig)
    return Config(
        model=ModelConfig(graph_num=FLAGSHIP["graph_num"], gnn_layer=2,
                          att_layer=1, latdim=64, num_heads=8, ssldim=48,
                          pos_length=200, spmm_backend="pallas",
                          remat_propagation=True, fusion_chunk_rows=16_384,
                          spmm_fold_gather=True),
        train=TrainConfig(batch=512, samp_num=10, ssl_num=8,
                          trn_num=FLAGSHIP["num_users"],
                          test_size=FLAGSHIP["test_size"]),
        data=DataConfig(data="synthetic"))


def _sharded_bytes_and_ops(ptr_ss, n_src, n_edges, d, elem):
    """K3's bytes, what the sum must move: the table once, the ids, the S
    row-pointer arrays and each f32 output row written once; operations:
    one add per gathered value. Also the bytes the per-shard schedule adds
    on top (not part of the bound): a read and a write of the f32 output
    row for every (shard, row) pair with edges, counted from the plan.
    Returns (bytes, operations, touched (shard, row) pairs, schedule
    bytes)."""
    touched = int((ptr_ss[:, 1:] > ptr_ss[:, :-1]).sum())
    n_tgt = ptr_ss.shape[1] - 1
    nbytes = (n_src * d * elem + n_edges * 4 + ptr_ss.numel() * 4
              + n_tgt * d * 4)
    return nbytes, n_edges * d, touched, touched * 2 * d * 4


def flagship_kernel_phase(graphs, shard_rows, device) -> dict:
    """K3 (accumulating, per source shard), K4 (row-folded, unsharded) and
    K3 with K4 on interval 0 of the flagship bundle, both directions, on
    f32 and bf16 tables: each forward against its plain version summed
    in f64 (K3: the per-shard plain version; K4: K1's), K4 bit-equal to
    K1 and the fold inside the shards bit-equal to K3; each backward (the
    autograd Functions' dx, on the transpose direction's plan) against
    the plain transpose sum in f64. Times each mode, its plain version,
    K1 and the library call (torch.sparse.mm on the whole CSR) on the
    same hops. Returns per-kernel records."""
    import torch
    from sagnn_tpu_torch.ops import spmm_cuda as sc

    gen = torch.Generator(device=device).manual_seed(12)
    D = 64
    ss = graphs["plans_ss"]
    records = {}
    for exact in (True, False):
        mode = "f32" if exact else "bf16"
        elem = 4 if exact else 2
        table = "exact f32 table" if exact else "bf16 table, f32 accumulation"
        k3 = _record(f"segsum_acc_{mode}", KERNEL_SOURCE, K3_REPLACES,
                     f"accumulate per source shard of {shard_rows} rows; "
                     + table)
        k4 = _record(f"segsum_fold_{mode}", KERNEL_SOURCE, K4_REPLACES,
                     "row-folded gathers, unsharded; " + table)
        k34 = _record(f"segsum_fold_acc_{mode}", KERNEL_SOURCE, K34_REPLACES,
                      "row-folded gathers inside each source shard, "
                      "accumulated; " + table)
        b3 = _record(f"segsum_acc_{mode}_bwd", KERNEL_SOURCE,
                     K3_BWD_REPLACES, "backward of a sharded hop: dx, K3 "
                     "per shard of the transpose plan; " + table)
        b4 = _record(f"segsum_fold_{mode}_bwd", KERNEL_SOURCE,
                     K4_BWD_REPLACES, "backward of a folded hop: dx, K4 on "
                     "the transpose plan; " + table)
        b34 = _record(f"segsum_fold_acc_{mode}_bwd", KERNEL_SOURCE,
                      K3_BWD_REPLACES, "backward of a folded sharded hop: "
                      "dx, K3 with K4 per shard of the transpose plan; "
                      + table)
        for d in ("u", "i"):
            o = "i" if d == "u" else "u"
            src, ptr = graphs[f"{d}_src"][0], graphs[f"{d}_ptr"][0]
            bsrc, bptr = graphs[f"{o}_src"][0], graphs[f"{o}_ptr"][0]
            lsrc, lptr = ss[f"{d}_src"][0], ss[f"{d}_ptr"][0]
            blsrc, blptr = ss[f"{o}_src"][0], ss[f"{o}_ptr"][0]
            n_src, n_tgt = bptr.numel() - 1, ptr.numel() - 1
            n = int(ptr[-1])
            x = torch.randn((n_src, D), generator=gen, device=device)
            g = torch.randn((n_tgt, D), generator=gen, device=device)
            rtol, atol = seg_tol(ptr, amax(x))
            brtol, batol = seg_tol(bptr, amax(g))

            # forwards
            want_ss = sc.spmm_apply_src_sharded_plain(x.double(), lsrc, lptr,
                                                      shard_rows, exact)
            want_k1 = sc.spmm_apply_plain(x.double(), src, ptr, exact)
            got3 = sc.spmm_apply_src_sharded(x, lsrc, lptr, shard_rows, exact)
            got4 = sc.spmm_apply(x, src, ptr, exact, folded=True)
            got34 = sc.spmm_apply_src_sharded(x, lsrc, lptr, shard_rows,
                                              exact, folded=True)
            got1 = sc.spmm_apply(x, src, ptr, exact)
            torch.cuda.synchronize()
            e3 = check_close(got3, want_ss, rtol, atol,
                             f"flagship {k3['name']}[{d}]")
            e4 = check_close(got4, want_k1, rtol, atol,
                             f"flagship {k4['name']}[{d}]")
            e34 = check_close(got34, want_ss, rtol, atol,
                              f"flagship {k34['name']}[{d}]")
            check(torch.equal(got4, got1), f"{k4['name']}[{d}]: K1's bits")
            check(torch.equal(got34, got3), f"{k34['name']}[{d}]: K3's bits")
            check_repeatable(lambda: sc.spmm_apply_src_sharded(
                x, lsrc, lptr, shard_rows, exact), f"{k3['name']}[{d}]")
            check_repeatable(lambda: sc.spmm_apply(
                x, src, ptr, exact, folded=True), f"{k4['name']}[{d}]")
            check_repeatable(lambda: sc.spmm_apply_src_sharded(
                x, lsrc, lptr, shard_rows, exact, folded=True),
                f"{k34['name']}[{d}]")
            log(f"  K3 vs K1 on the same hop: max abs diff "
                f"{max_err(got3, got1):.3e}")
            del want_ss, want_k1, got3, got4, got34, got1
            a = _csr(ptr, src, torch.ones(n, device=device), (n_tgt, n_src))
            xl = x if exact else x.to(torch.bfloat16).float()
            k1_ms = kernel_ms(lambda: sc.spmm_apply(x, src, ptr, exact),
                              iters=10)
            library_ms = kernel_ms(lambda: torch.sparse.mm(a, xl), iters=10)
            plain_k1 = kernel_ms(lambda: sc.spmm_apply_plain(x, src, ptr,
                                                             exact), iters=5)
            plain_ss = kernel_ms(lambda: sc.spmm_apply_src_sharded_plain(
                x, lsrc, lptr, shard_rows, exact), iters=5)
            nbytes3, ops3, touched, sched3 = _sharded_bytes_and_ops(
                lptr, n_src, n, D, elem)
            nbytes1 = (n_src * D * elem + n * 4 + (n_tgt + 1) * 4
                       + n_tgt * D * 4)
            shape = dict(edges=n, num_src=n_src, num_tgt=n_tgt,
                         shards=int(lptr.shape[0]),
                         touched_shard_rows=touched,
                         max_degree=int((ptr[1:] - ptr[:-1]).max()),
                         k1_ms=k1_ms, library_ms=library_ms)
            _add(k3, d, e3, ms=kernel_ms(lambda: sc.spmm_apply_src_sharded(
                x, lsrc, lptr, shard_rows, exact), iters=10),
                plain_ms=plain_ss, bound_ms=_bound_ms(nbytes3, ops3),
                unique_bytes=nbytes3, schedule_bytes=sched3, **shape)
            _add(k4, d, e4, ms=kernel_ms(lambda: sc.spmm_apply(
                x, src, ptr, exact, folded=True), iters=10),
                plain_ms=plain_k1, bound_ms=_bound_ms(nbytes1, n * D),
                unique_bytes=nbytes1, **shape)
            _add(k34, d, e34, ms=kernel_ms(lambda: sc.spmm_apply_src_sharded(
                x, lsrc, lptr, shard_rows, exact, folded=True), iters=10),
                plain_ms=plain_ss, bound_ms=_bound_ms(nbytes3, ops3),
                unique_bytes=nbytes3, schedule_bytes=sched3, **shape)

            # backwards: dx through each Function on the transpose plans
            xv = x.clone().requires_grad_()
            want_bss = sc.spmm_apply_src_sharded_plain(g.double(), blsrc,
                                                       blptr, shard_rows,
                                                       exact)
            want_b1 = sc.spmm_apply_plain(g.double(), bsrc, bptr, exact)
            dx3, = torch.autograd.grad(sc.spmm_src_sharded(
                xv, lsrc, lptr, blsrc, blptr, shard_rows, exact), xv, g)
            dx4, = torch.autograd.grad(sc.spmm(
                xv, src, ptr, bsrc, bptr, exact, True), xv, g)
            dx34, = torch.autograd.grad(sc.spmm_src_sharded(
                xv, lsrc, lptr, blsrc, blptr, shard_rows, exact, True), xv,
                g)
            torch.cuda.synchronize()
            eb3 = check_close(dx3, want_bss, brtol, batol,
                              f"flagship {b3['name']}[{d}-hop dx]")
            eb4 = check_close(dx4, want_b1, brtol, batol,
                              f"flagship {b4['name']}[{d}-hop dx]")
            eb34 = check_close(dx34, want_bss, brtol, batol,
                               f"flagship {b34['name']}[{d}-hop dx]")
            check(torch.equal(dx34, dx3), f"{b34['name']}[{d}]: K3's bits")
            check_repeatable(lambda: torch.autograd.grad(sc.spmm_src_sharded(
                xv, lsrc, lptr, blsrc, blptr, shard_rows, exact, True), xv,
                g)[0], f"{b34['name']}[{d}-hop dx]")
            check_repeatable(lambda: torch.autograd.grad(sc.spmm(
                xv, src, ptr, bsrc, bptr, exact, True), xv, g)[0],
                f"{b4['name']}[{d}-hop dx]")
            del want_bss, want_b1, dx3, dx4, dx34
            at = _csr(bptr, bsrc, torch.ones(n, device=device),
                      (n_src, n_tgt))
            gl = g if exact else g.to(torch.bfloat16).float()
            bk1_ms = kernel_ms(lambda: sc.spmm_apply(g, bsrc, bptr, exact),
                               iters=10)
            blibrary_ms = kernel_ms(lambda: torch.sparse.mm(at, gl), iters=10)
            bplain_k1 = kernel_ms(lambda: sc.spmm_apply_plain(
                g, bsrc, bptr, exact), iters=5)
            bplain_ss = kernel_ms(lambda: sc.spmm_apply_src_sharded_plain(
                g, blsrc, blptr, shard_rows, exact), iters=5)
            bbytes3, bops3, btouched, bsched3 = _sharded_bytes_and_ops(
                blptr, n_tgt, n, D, elem)
            bbytes1 = (n_tgt * D * elem + n * 4 + (n_src + 1) * 4
                       + n_src * D * 4)
            bshape = dict(plan=o, edges=n, shards=int(blptr.shape[0]),
                          touched_shard_rows=btouched, k1_ms=bk1_ms,
                          library_ms=blibrary_ms)
            _add(b3, d, eb3, ms=kernel_ms(lambda: sc.spmm_apply_src_sharded(
                g, blsrc, blptr, shard_rows, exact), iters=10),
                plain_ms=bplain_ss, bound_ms=_bound_ms(bbytes3, bops3),
                unique_bytes=bbytes3, schedule_bytes=bsched3, **bshape)
            _add(b4, d, eb4, ms=kernel_ms(lambda: sc.spmm_apply(
                g, bsrc, bptr, exact, folded=True), iters=10),
                plain_ms=bplain_k1, bound_ms=_bound_ms(bbytes1, n * D),
                unique_bytes=bbytes1, **bshape)
            _add(b34, d, eb34, ms=kernel_ms(lambda: sc.spmm_apply_src_sharded(
                g, blsrc, blptr, shard_rows, exact, folded=True), iters=10),
                plain_ms=bplain_ss, bound_ms=_bound_ms(bbytes3, bops3),
                unique_bytes=bbytes3, schedule_bytes=bsched3, **bshape)
        for rec in (k3, k4, k34, b3, b4, b34):
            rec["k1_ms"] = sum(v["k1_ms"]
                               for v in rec["per_direction"].values())
            rec["tolerance"] = SEG_TOL + " (of the whole plan)"
            rec["bound_counts"] = (
                "the table once, the ids, the row pointers (K3: the S "
                "arrays) and the f32 output once, at 3.35e12 B/s; "
                "operations: one f32 add per gathered value at 67e12 "
                "FLOP/s. K3's schedule_bytes, not in the bound: a read and "
                "a write of the output row per (shard, row) pair with "
                "edges")
            records[rec["name"]] = rec
            log(f"{rec['name']}: u {rec['per_direction']['u']['ms']:.4f} ms"
                f", i {rec['per_direction']['i']['ms']:.4f} ms; K1 "
                f"{rec['k1_ms']:.4f} ms; plain {rec['plain_ms']:.4f} ms; "
                f"library {rec['library_ms']:.4f} ms; bound "
                f"{rec['bound_ms']:.4f} ms; max abs err "
                f"{rec['max_abs_err']:.3e}")
    return records


def full_sort_tie_check(trainer, n_items, device) -> dict:
    """Dense and streamed full-sort ranks of every test user of `trainer`
    over a catalog cut to n_items rows (to fit dense scoring) whose second
    half is a copy of its first, each positive moved into the copied half,
    so that it ties exactly with its twin (and every item with one other):
    the two protocols' ranks must be equal, element for element. Streamed
    in AUTO_CHUNK_ROWS chunks, as the Trainer streams past DENSE_MAX_ROWS.
    Returns the times and the count of positives whose twin is ranked."""
    import numpy as np
    import torch
    from sagnn_tpu_torch.ops.chunking import AUTO_CHUNK_ROWS
    from sagnn_tpu_torch.train.metrics import (dense_positive_ranks,
                                               streaming_positive_ranks)

    params, tc = trainer.state["params"], trainer.cfg.train
    half = n_items // 2
    users = np.asarray(trainer.bundle.tst_usrs)
    out = {"users": len(users), "items": 2 * half,
           "chunk_items": AUTO_CHUNK_ROWS, "dense_s": 0.0, "streamed_s": 0.0,
           "twins_ranked": 0}
    with torch.no_grad():
        fu, fi, _, _ = trainer.model.encode(params, trainer.graphs)
        table = torch.cat([fi[:half], fi[:half]])
        for s in range(0, len(users), tc.batch):
            uid, pos, seq, seq_mask, excl, valid = (
                torch.from_numpy(a).to(device) for a in
                trainer.sampler.full_sort_batch(users[s:s + tc.batch],
                                                test_mode=tc.test_mode))
            pos = half + pos % half
            excl = torch.where((excl >= 2 * half) | (excl == pos[:, None]),
                               2 * half, excl)
            q = trainer.model.serving_queries(params, fu, fi, uid, seq,
                                              seq_mask)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dense = dense_positive_ranks(q, table, pos, excl)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            streamed = streaming_positive_ranks(q, table, pos, excl,
                                                2 * half, AUTO_CHUNK_ROWS)
            torch.cuda.synchronize()
            out["dense_s"] += t1 - t0
            out["streamed_s"] += time.perf_counter() - t1
            diff = int((dense != streamed).sum())
            check(diff == 0, f"full-sort ranks, users {s}+: {diff} of "
                  f"{len(dense)} differ between dense and streamed")
            twin_out = (excl == (pos - half)[:, None]).any(1)
            out["twins_ranked"] += int(((valid > 0) & ~twin_out).sum())
    log(f"full-sort tie check: {out['users']} users x {out['items']} items "
        f"(second half a copy of the first), dense and streamed ranks equal;"
        f" {out['twins_ranked']} positives tie with a ranked twin; dense "
        f"{out['dense_s']:.3f} s, streamed {out['streamed_s']:.3f} s")
    return out


def flagship_phase(device) -> tuple[dict, dict, dict, object]:
    """The 1M-user flagship through the entry points: the bundle of
    scripts/bench_1m.py, a `Trainer` with the exact_b512 recipe (auto
    shard rows resolved to FLAGSHIP_SHARD_ROWS, sharded plans attached),
    a `Recommender` with the fold off on the same weights; K3 and K4 on
    interval 0 against their plain versions (`flagship_kernel_phase`);
    the Recommender's encode (K3 launches read just after it) against
    the plain backend's propagation in f64, a recommend for
    SERVE_USERS users and an evaluation of EVAL_USERS test users; a
    bf16-table encode held hop by hop; one full-width step at keepRate 1
    (K3 with K4, forward, recompute and backward) against the plain path
    with its propagation in f64; the same step with the fold off and on
    bf16 tables; FLAGSHIP_STEPS + 1 `Trainer.train_step`s at keepRate 0.5,
    timed, with the device's peak memory, and a profiler pass over two
    more; the Trainer's full-sort evaluation of every test user (streamed
    over the catalog) and `full_sort_tie_check` on a cut catalog. Returns
    (results, records, interval 0's CSR plans for phase 14, the bundle for
    phase 17)."""
    import torch
    from sagnn_tpu_torch.data.synthetic import synthetic_large_dataset
    from sagnn_tpu_torch.models import selfgnn
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.serve import Recommender
    from sagnn_tpu_torch.train.trainer import Trainer

    cfg = flagship_config()
    tc = cfg.train
    nu, ni = FLAGSHIP["num_users"], FLAGSHIP["num_items"]
    out = {"host_s": {}}
    t0 = time.perf_counter()
    bundle = synthetic_large_dataset(**FLAGSHIP)
    out["host_s"]["bundle"] = time.perf_counter() - t0
    out["interval_edges"] = [m.nnz for m in bundle.sub_mats]
    log(f"flagship bundle: {nu} users x {ni} items, "
        f"{FLAGSHIP['total_edges']} edges drawn, interval edges "
        f"{out['interval_edges']}; {out['host_s']['bundle']:.1f} s")
    root = tempfile.mkdtemp()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, bundle, ckpt_root=root, device=device)
    torch.cuda.synchronize()
    out["host_s"]["trainer"] = time.perf_counter() - t0
    mc = trainer.cfg.model
    rows = mc.spmm_src_shard_rows
    check(rows == FLAGSHIP_SHARD_ROWS, f"shard rows resolved to {rows}")
    ss = trainer.graphs["plans_ss"]
    s_u, s_i = ss["u_ptr"].shape[1], ss["i_ptr"].shape[1]
    check((s_u, s_i) == (sc.num_shards(ni, rows), sc.num_shards(nu, rows)),
          f"shards u {s_u}, i {s_i}")
    per_encode = mc.graph_num * mc.gnn_layer * (s_u + s_i)
    if (nu, ni) == (1_048_576, 786_432):
        check(per_encode == FLAGSHIP_ENCODE_LAUNCHES,
              f"{per_encode} K3 launches per encode")
    log(f"flagship Trainer: shard rows {rows}, shards u {s_u} / i {s_i}, "
        f"{per_encode} K3 launches per encode (predicted "
        f"{FLAGSHIP_ENCODE_LAUNCHES}); set-up {out['host_s']['trainer']:.1f}"
        f" s")
    t0 = time.perf_counter()
    rec = Recommender(cfg.replace(model=dataclasses.replace(
        cfg.model, spmm_fold_gather=False)), bundle,
        trainer.state["params"], device=device)
    torch.cuda.synchronize()
    out["host_s"]["recommender"] = time.perf_counter() - t0
    check(rec.cfg.model.spmm_src_shard_rows == rows
          and "plans_ss" in rec.graphs, "the Recommender serves sharded")

    t0 = time.perf_counter()
    records = flagship_kernel_phase(rec.graphs, rows, device)
    out["kernels_s"] = time.perf_counter() - t0

    # serving: the encode through K3, its launches read just after it
    launches = {}
    sc.reset_launches()
    fu, fi = rec.encode()
    torch.cuda.synchronize()
    launches["encode"] = dict(sc.LAUNCHES)
    log(f"flagship encode launches: {launches['encode']}")
    expect_launches(launches["encode"], "flagship encode",
                    segsum_acc_f32=per_encode)
    check(fu.shape == (nu, 64) and fi.shape == (ni, 64), "encoding shapes")
    smc = rec.cfg.model
    plain_cfg = dataclasses.replace(smc, spmm_backend="xla")
    p64 = dict(rec.params)
    for key in ("reg/u_embed", "reg/i_embed"):
        p64[key] = p64[key].detach().double()
    with torch.no_grad():
        uv64, iv64 = selfgnn._interval_propagation(p64, rec.graphs,
                                                   plain_cfg, nu, ni)
        uv, iv = selfgnn._interval_propagation(rec.params, rec.graphs, smc,
                                               nu, ni)
        ru, ri = selfgnn._temporal_fusion(rec.params, uv64.float(),
                                          iv64.float(), smc)
    torch.cuda.synchronize()
    check_close(uv, uv64, 1e-5, 1e-5, "flagship user_vec kernel vs plain f64")
    check_close(iv, iv64, 1e-5, 1e-5, "flagship item_vec kernel vs plain f64")
    err_u = check_close(fu, ru, 1e-4, 1e-5, "flagship final_user vs plain")
    err_i = check_close(fi, ri, 1e-4, 1e-5, "flagship final_item vs plain")
    del p64, uv64, iv64, uv, iv, ru, ri
    out["encode_ms"] = cuda_ms(rec.encode, iters=3, warmup=1)

    def propagate():
        with torch.no_grad():
            return selfgnn._interval_propagation(rec.params, rec.graphs, smc,
                                                 nu, ni)

    out["propagation_ms"] = cuda_ms(propagate, iters=3, warmup=1)
    out["max_abs_err_final"] = max(err_u, err_i)
    log(f"flagship encode {out['encode_ms']:.2f} ms: propagation "
        f"{out['propagation_ms']:.2f} ms ({per_encode} K3 launches)")

    users = bundle.tst_usrs[:SERVE_USERS]
    scores, items = rec.recommend(users, k=10)
    torch.cuda.synchronize()
    check(scores.shape == items.shape == (len(users), 10)
          and bool(torch.isfinite(scores).all())
          and bool((scores[:, :-1] >= scores[:, 1:]).all()),
          "flagship top-k")
    items_np = items.cpu().numpy()
    for b, u in enumerate(users):
        seen = set(bundle.sequences[u][-smc.pos_length:].tolist())
        check(not seen & set(items_np[b].tolist()), "seen item served")
    out["recommend_ms"] = cuda_ms(lambda: rec.recommend(users, k=10),
                                  iters=3, warmup=1)
    t0 = time.perf_counter()
    metrics = rec.evaluate(max_users=EVAL_USERS)
    torch.cuda.synchronize()
    out["evaluate_s"] = time.perf_counter() - t0
    out["evaluate_users"] = min(EVAL_USERS, len(bundle.tst_usrs))
    for k, v in metrics.items():
        check(math.isfinite(v) and 0.0 <= v <= 1.0, f"metric {k}={v}")
    out["metrics"] = {k: metrics[k] for k in ("HR@10", "NDCG@10")}
    log(f"flagship recommend {SERVE_USERS} users {out['recommend_ms']:.2f}"
        f" ms; evaluate {out['evaluate_users']} users "
        f"{out['evaluate_s']:.2f} s, HR@10 {metrics['HR@10']:.4f}")

    # the encode on bf16 tables, held hop by hop
    mc16 = dataclasses.replace(smc, spmm_exact=False)
    m16 = selfgnn.SelfGNN(mc16, nu, ni)
    sc.reset_launches()
    fu16, fi16, uv16, iv16 = m16.encode(rec.params, rec.graphs)
    torch.cuda.synchronize()
    launches["bf16_encode"] = dict(sc.LAUNCHES)
    expect_launches(launches["bf16_encode"], "flagship bf16 encode",
                    segsum_acc_bf16=per_encode)
    with torch.no_grad():
        uv_ref, iv_ref = bf16_propagation_reference(
            rec.params, rec.graphs, mc16, nu, ni, attr="spmm_src_sharded")
    check_close(uv16, uv_ref, 1e-5, 1e-5, "flagship bf16 user_vec")
    check_close(iv16, iv_ref, 1e-5, 1e-5, "flagship bf16 item_vec")
    out["bf16_dev_from_f32_encode"] = max(max_err(fu16, fu),
                                          max_err(fi16, fi))
    del uv_ref, iv_ref, uv16, iv16, fu16, fi16, fu, fi
    out["bf16_encode_ms"] = cuda_ms(lambda: m16.encode(rec.params,
                                                       rec.graphs),
                                    iters=3, warmup=1)
    log(f"flagship bf16 encode {out['bf16_encode_ms']:.2f} ms; max abs "
        f"deviation from the f32 encode {out['bf16_dev_from_f32_encode']:.3e}")
    del rec

    # one full-width step at keepRate 1 against the plain path
    ids = trainer.sampler.epoch_user_ids(tc.trn_num)
    t0 = time.perf_counter()
    host_batch = trainer.sampler.train_batch(ids[:tc.batch])
    out["host_sample_ms_one_batch"] = (time.perf_counter() - t0) * 1e3
    batch = host_batch.to(device)
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in trainer.state["params"].items()}
    keys = sorted(leaves)
    mc1 = dataclasses.replace(mc, keep_rate=1.0)
    recipe = selfgnn.SelfGNN(mc1, nu, ni)
    kinks = []
    sc.reset_launches()
    with kernel_kinks(kinks):
        got = loss_and_grads(recipe, leaves, trainer.graphs, batch, tc)
    torch.cuda.synchronize()
    launches["step"] = dict(sc.LAUNCHES)
    log(f"flagship step launches: {launches['step']}")
    # remat: every hop runs in the forward and again in the backward's
    # recompute, then once backward
    expect_launches(launches["step"], "flagship step",
                    segsum_fold_acc_f32=2 * per_encode,
                    segsum_fold_acc_f32_bwd=per_encode)
    ref_model = selfgnn.SelfGNN(dataclasses.replace(
        mc1, remat_propagation=False), nu, ni)
    with f64_propagation(kinks):
        want = loss_and_grads(ref_model, leaves, trainer.graphs, batch, tc)
    torch.cuda.synchronize()
    share, worst = check_step(got, want, "flagship step")
    out["grad_check_share"], out["grad_check_worst"] = share, worst
    g_max = max(float(g.abs().max()) for g in want[2].values())
    del want

    # the same step with the fold off (K3 alone) and on bf16 tables
    for name, variant, want_launches in (
            ("step_fold_off", dict(spmm_fold_gather=False),
             dict(segsum_acc_f32=2 * per_encode,
                  segsum_acc_f32_bwd=per_encode)),
            ("step_bf16", dict(spmm_exact=False),
             dict(segsum_fold_acc_bf16=2 * per_encode,
                  segsum_fold_acc_bf16_bwd=per_encode)),
            ("step_bf16_fold_off", dict(spmm_exact=False,
                                        spmm_fold_gather=False),
             dict(segsum_acc_bf16=2 * per_encode,
                  segsum_acc_bf16_bwd=per_encode))):
        model = selfgnn.SelfGNN(dataclasses.replace(mc1, **variant), nu, ni)
        sc.reset_launches()
        res = loss_and_grads(model, leaves, trainer.graphs, batch, tc)
        torch.cuda.synchronize()
        launches[name] = dict(sc.LAUNCHES)
        expect_launches(launches[name], f"flagship {name}", **want_launches)
        rtol = 1e-6 if name == "step_fold_off" else BF16_LOSS_RTOL
        check_close(res[0].reshape(1), got[0].reshape(1), rtol, 0.0,
                    f"flagship {name} preLoss vs the recipe's")
        check_close(res[1].reshape(1), got[1].reshape(1), rtol, 0.0,
                    f"flagship {name} sslloss vs the recipe's")
        check(all(bool(torch.isfinite(g).all()) for g in res[2].values()),
              f"flagship {name} gradients finite")
        out[f"{name}_grad_dev_over_max_g"] = max(
            max_err(res[2][k], got[2][k]) for k in keys) / g_max
        log(f"  {name}: gradients' max abs deviation from the recipe's "
            f"step {out[f'{name}_grad_dev_over_max_g']:.3e} x max|g|")
        del res
    del got, leaves, kinks

    # Trainer steps at keepRate 0.5 (the recipe as it trains), timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sc.reset_launches()
    step_s, sample_ms, losses = [], [], []
    for i in range(1, FLAGSHIP_STEPS + 2):
        t0 = time.perf_counter()
        b = trainer.sampler.train_batch(ids[i * tc.batch:(i + 1) * tc.batch])
        sample_ms.append((time.perf_counter() - t0) * 1e3)
        b = b.to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = trainer.train_step(b)
        losses.append({k: float(v) for k, v in stats.items()})
        step_s.append(time.perf_counter() - t0)
    launches["trainer_steps"] = dict(sc.LAUNCHES)
    n_steps = FLAGSHIP_STEPS + 1
    expect_launches(launches["trainer_steps"], "flagship Trainer steps",
                    segsum_fold_acc_f32=2 * per_encode * n_steps,
                    segsum_fold_acc_f32_bwd=per_encode * n_steps)
    check(all(math.isfinite(v) for s in losses for v in s.values()),
          "flagship Trainer losses finite")
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["trainer_step_s"] = step_s
    out["trainer_step_s_mean_after_first"] = sum(step_s[1:]) / len(step_s[1:])
    out["host_sample_ms"] = sample_ms
    out["trainer_losses"] = losses
    # where a step's device time goes (the last batch, sampling apart)
    out["profile"] = profile_steps(lambda: trainer.train_step(b), n=2)

    # the step's K3 launches alone: the 2 x per_encode forward launches
    # (forward and recompute) and per_encode backward launches on their
    # plans, on random tables (a segment-sum's time does not depend on
    # the values)
    gen = torch.Generator(device=device).manual_seed(13)
    tables = {"u": torch.randn((nu, 64), generator=gen, device=device),
              "i": torch.randn((ni, 64), generator=gen, device=device)}
    gss = trainer.graphs["plans_ss"]

    def k3_step():
        for k in range(mc.graph_num):
            for _ in range(mc.gnn_layer):
                for d, o in (("u", "i"), ("i", "u")):
                    for plan, table in ((d, o), (d, o), (o, d)):
                        sc.spmm_apply_src_sharded(
                            tables[table], gss[f"{plan}_src"][k],
                            gss[f"{plan}_ptr"][k], rows, True, True)

    out["k3_per_step_ms"] = cuda_ms(k3_step, iters=2, warmup=1)
    log(f"flagship Trainer steps (keepRate 0.5): "
        + ", ".join(f"{t:.3f}" for t in step_s) + " s (the first included);"
        f" K3 launches alone {out['k3_per_step_ms']:.1f} ms per step; peak "
        f"device memory {out['peak_memory_gb']:.2f} GB; host sampling "
        f"{sum(sample_ms) / len(sample_ms):.1f} ms per batch")
    # full sort: every test user against the 786,432-item catalog,
    # streamed in AUTO_CHUNK_ROWS chunks (past DENSE_MAX_ROWS)
    from sagnn_tpu_torch.ops.chunking import auto_chunk_rows
    check(auto_chunk_rows(ni) > 0, "the flagship's full sort streams")
    t0 = time.perf_counter()
    metrics = trainer.test_epoch(full_sort=True)
    torch.cuda.synchronize()
    out["full_sort_s"] = time.perf_counter() - t0
    out["full_sort_users"] = len(bundle.tst_usrs)
    out["full_sort_metrics"] = {k: metrics[k] for k in ("HR@10", "NDCG@10")}
    for k, v in metrics.items():
        check(math.isfinite(v) and 0.0 <= v <= 1.0,
              f"flagship full-sort metric {k}={v}")
    log(f"flagship full-sort evaluate (streamed, {auto_chunk_rows(ni)}-item"
        f" chunks) over {out['full_sort_users']} users x {ni} items: "
        f"{out['full_sort_s']:.2f} s, HR@10 {metrics['HR@10']:.4f}")
    out["full_sort_ties"] = full_sort_tie_check(trainer, FULL_SORT_CUT_ITEMS,
                                                device)

    out["launches"] = {k: {n: c for n, c in v.items() if c}
                       for k, v in launches.items()}
    out["per_encode_launches"] = per_encode
    out["shard_rows"], out["shards"] = rows, {"u": s_u, "i": s_i}
    hops0 = {k: trainer.graphs[k][:1].clone()
             for k in ("u_src", "u_ptr", "i_src", "i_ptr")}
    shutil.rmtree(root, ignore_errors=True)
    return out, records, hops0, bundle


def p1_kernels_per_call(device) -> dict:
    """The CUDA kernels one P1 call makes, per table type, counted on a
    small table (`cuda_kernels_per_call`; the count does not depend on the
    sizes). It is counted here, before the flagship phase: after that
    phase's profiler pass, a new profiler session on this card has read
    no device events."""
    import torch
    from sagnn_tpu_torch.ops import probes

    x = torch.randn((20_000, probes.D), device=device)
    src = torch.from_numpy(probes.probe_ids(20_000, 300_000, 1)).to(device)
    return {f"gather_sum_{mode}": cuda_kernels_per_call(
                lambda: probes.gather_sum(table, src))
            for mode, table in (("f32", x), ("bf16", x.to(torch.bfloat16)))}


def probes_phase(gowalla, flagship, p1_kernels, device
                 ) -> tuple[dict, dict]:
    """Phase 14. P1 (`probes.gather_sum`) in every mode (f32 and bf16
    tables, every run and loads-in-flight count) on the probe's own shape
    against its plain version summed in f64, atol = f32 eps x rows x
    max|x|, and on interval 0's gowalla hop streams; P2
    (`probes.segsum_ablate`) on interval 0's gowalla and flagship hops,
    both table types, against its plain version, exactly; each record's
    kernel, plain (= library for P1) and bound times. Then, with every
    count set to 0, `probes.run` (the CLI's measurements: P1's sweeps on
    an HBM-size and an L2-size table, the plans' factors, the split of K1
    on both bundles' interval 0), its counts read just after.
    `p1_kernels`: `p1_kernels_per_call`'s counts, logged with the records.
    Returns (the run's results, records)."""
    import torch
    from sagnn_tpu_torch.ops import probes
    from sagnn_tpu_torch.ops import spmm_cuda as sc

    gen = torch.Generator(device=device).manual_seed(14)
    D = probes.D
    records = {}
    x32 = torch.randn((probes.PROBE_ROWS, D), generator=gen, device=device)
    for x in (x32, x32.to(torch.bfloat16)):
        mode = "f32" if x.dtype == torch.float32 else "bf16"
        rec = _record(f"gather_sum_{mode}", PROBES_SOURCE, P1_REPLACES,
                      f"{mode} table, f32 sums; P1 at the probe's shape")
        x64 = x.double()
        worst = 0.0
        for run in probes.RUNS:
            src = torch.from_numpy(probes.probe_ids(
                probes.PROBE_ROWS, probes.PROBE_FETCHED, run)).to(device)
            want = probes.gather_sum_plain(x64, src, run)
            atol = F32_EPS * src.numel() * run * amax(x)
            for k in probes.IN_FLIGHT:
                got = probes.gather_sum(x, src, run, k)
                err, used = tolerance_used(got, want, 0.0, atol)
                check(used <= 1.0, f"{rec['name']} run {run} in flight {k}:"
                      f" max abs err {err:.3e} (atol {atol:.2e})")
                check_repeatable(lambda: probes.gather_sum(x, src, run, k),
                                 f"{rec['name']} run {run} in flight {k}")
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                worst = max(worst, used)
        # on the gowalla hops' own edge streams (the split's input)
        for d, o in (("u", "i"), ("i", "u")):
            n = int(gowalla[f"{d}_ptr"][0][-1])
            stream = gowalla[f"{d}_src"][0][:n]
            table = torch.randn((gowalla[f"{o}_ptr"].shape[-1] - 1, D),
                                generator=gen, device=device).to(x.dtype)
            want = probes.gather_sum_plain(table.double(), stream)
            atol = F32_EPS * n * amax(table)
            err, used = tolerance_used(probes.gather_sum(table, stream),
                                       want, 0.0, atol)
            check(used <= 1.0, f"{rec['name']} on the gowalla {d}-hop")
            check_repeatable(lambda: probes.gather_sum(table, stream),
                             f"{rec['name']} on the gowalla {d}-hop")
            worst = max(worst, used)
        log(f"  {rec['name']}: {len(probes.RUNS) * len(probes.IN_FLIGHT)} "
            f"modes and the gowalla hop streams within {worst:.2f} of atol"
            f" = f32 eps x rows x max|x|; max abs err {rec['max_abs_err']:.3e}")
        # the record's times: run 1 at K1's unroll, on the probe's shape
        src = torch.from_numpy(probes.probe_ids(
            probes.PROBE_ROWS, probes.PROBE_FETCHED, 1)).to(device)
        nbytes = _p1_bytes(x, src)
        library_ms = kernel_ms(lambda: probes.gather_sum_plain(x, src))
        sched = probes.gather_schedule(src.numel(), 1, D,
                                       sc._sm_count(device.index),
                                       x.element_size())
        per_call = p1_kernels[rec["name"]]
        rec["cuda_kernels_per_call"] = per_call
        log(f"schedule {rec['name']} (modelled: gather_schedule, except the "
            f"measured kernels per call): {sched.vec} values "
            f"({sched.vec * x.element_size()} bytes) per lane, "
            f"{sched.lanes} lanes per row, {sched.rows_per_instruction} rows "
            f"per warp load; {sched.chunks} chunks of "
            f"{probes.P1_CHUNK_ROWS} rows on {sched.blocks} blocks; CUDA "
            f"kernels per call {per_call}")
        rec.update(
            ms=kernel_ms(lambda: probes.gather_sum(x, src)),
            plain_ms=library_ms, library_ms=library_ms,
            bound_ms=_bound_ms(nbytes, src.numel() * D),
            unique_bytes=nbytes, rows=src.numel(), table_rows=x.shape[0],
            in_flight=probes.SPLIT_IN_FLIGHT, run=1,
            tolerance="atol f32 eps x rows x max|x| against the f64 sum",
            timed=("ms/plain_ms/library_ms/bound_ms: 1,048,576 rows "
                   "gathered from a 1,048,576 x 64 table (HBM), run 1, "
                   f"{probes.SPLIT_IN_FLIGHT} loads in flight; plain and "
                   "library are one call, x.index_select(0, src).float()"
                   ".sum(0); device time per call (profiling.device_ms)"))
        records[rec["name"]] = rec
    del x32, x64

    for exact, mode in ((True, "f32"), (False, "bf16")):
        elem = 4 if exact else 2
        rec = _record(f"segsum_ablate_{mode}", KERNEL_SOURCE, P2_REPLACES,
                      f"K1's walk and loads, no adds; {mode} table")
        rec.update(library_ms=None, flagship={}, tolerance="exact",
                   timed=("ms/plain_ms/bound_ms: one user-target plus one "
                          "item-target hop on interval 0 of the "
                          "gowalla-scale bundle (flagship: the same on the "
                          "flagship bundle), device time per call "
                          "(profiling.device_ms); library_ms: no one "
                          "PyTorch call computes it"))
        for bundle_name, graphs in (("gowalla", gowalla),
                                    ("flagship", flagship)):
            for d, o in (("u", "i"), ("i", "u")):
                src, ptr = graphs[f"{d}_src"][0], graphs[f"{d}_ptr"][0]
                n_src, n_tgt = graphs[f"{o}_ptr"].shape[-1] - 1, \
                    ptr.numel() - 1
                n = int(ptr[-1])
                x = torch.randn((n_src, D), generator=gen, device=device)
                got = probes.segsum_ablate(x, src, ptr, exact)
                want = probes.segsum_ablate_plain(x, src, ptr, exact)
                check(torch.equal(got, want),
                      f"{rec['name']} {bundle_name}[{d}]: exactly the last "
                      "source rows")
                check_repeatable(lambda: probes.segsum_ablate(
                    x, src, ptr, exact), f"{rec['name']} {bundle_name}[{d}]")
                distinct = int(torch.unique(src[:n]).numel())
                nbytes = (distinct * D * elem + n * 4 + (n_tgt + 1) * 4
                          + n_tgt * D * 4)
                times = dict(
                    ms=kernel_ms(lambda: probes.segsum_ablate(x, src, ptr,
                                                              exact),
                                 iters=10),
                    plain_ms=kernel_ms(lambda: probes.segsum_ablate_plain(
                        x, src, ptr, exact), iters=10),
                    bound_ms=_bound_ms(nbytes, 0), unique_bytes=nbytes,
                    distinct_rows=distinct, edges=n,
                    max_degree=int((ptr[1:] - ptr[:-1]).max()))
                if bundle_name == "gowalla":
                    _add(rec, d, 0.0, library_ms=None, **times)
                else:
                    rec["flagship"][d] = times
        fl = rec["flagship"]
        rec["flagship"]["pair"] = {k: fl["u"][k] + fl["i"][k]
                                   for k in ("ms", "plain_ms", "bound_ms")}
        records[rec["name"]] = rec
        log(f"{rec['name']}: gowalla pair {rec['ms']:.4f} ms (bound "
            f"{rec['bound_ms']:.4f}), flagship pair {fl['pair']['ms']:.4f} "
            "ms; every row exact")

    # the probes' path: the CLI's measurements, counts read just after
    sc.reset_launches()
    probes.reset_launches()
    t0 = time.perf_counter()
    result = probes.run(device, gowalla, flagship)
    torch.cuda.synchronize()
    result["run_s"] = time.perf_counter() - t0
    launches = dict(probes.LAUNCHES)
    k1 = {k: v for k, v in sc.LAUNCHES.items() if v}
    log(f"probes run launches: {launches}; K1 {k1}")
    for name, rec in records.items():
        rec["launches"] = launches[name]
        rec["launches_path"] = "probes.run (the probe CLI's measurements)"
    for name, sp in result["split"].items():
        for mode in ("f32", "bf16"):
            pair = sp[mode]["pair"]
            log(f"split {name} {mode}: K1 pair {pair['k1_ms']:.4f} ms = "
                f"loads (P1) {pair['p1_ms']:.4f} + walk (P2 - P1) "
                f"{pair['walk_ms']:.4f} + adds (K1 - P2) "
                f"{pair['adds_ms']:.4f}; longest i-row under P2 "
                f"{sp[mode]['i']['p2_ns_per_edge_longest']:.1f} ns per edge,"
                f" K1 {sp[mode]['i']['k1_ns_per_edge_longest']:.1f}")
    return result, records


def bf16_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of max |want| (one ulp: 2^(floor(log2
    max|want|) - 7)); inf where got is not finite."""
    import torch
    got, want = got.double(), want.double()
    if not bool(torch.isfinite(got).all()):
        return math.inf
    ulp = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    return float((got - want).abs().max()) / ulp


def check_ulps(got, want, bound, what) -> float:
    """Fails unless got is within `bound` bf16 ulps of max|want|; logs the
    ulps and the share of elements that differ at all."""
    ulps = bf16_ulps(got, want)
    differ = float((got.double() != want.double()).float().mean())
    check(ulps <= bound, f"{what}: {ulps:.2f} bf16 ulps of max|value| "
          f"(bound {bound})")
    log(f"  {what}: {ulps:.2f} bf16 ulps of max|value| (bound {bound}); "
        f"{differ:.4f} of the elements differ")
    return ulps


def bf16_stream_error(q, table, ids):
    """A bound on |bf16 stream score - exact score| of items `ids` [B, k]
    for queries q [B, D]: rounding q and a row to bf16 (2^-9 relative
    each) moves each product q_i t_i by at most (2^-8 + 2^-18)|q_i t_i|,
    the f32 sum adds less than 2^-18 of sum |q_i t_i| at D = 64, and the
    score rounds to bf16 (2^-9 relative): 2^-8 (1.01 sum |q_i t_i| + |s|)
    bounds it."""
    import torch
    rows = table[ids].double()
    qd = q.double()[:, None, :]
    return 2.0 ** -8 * (1.01 * (qd.abs() * rows.abs()).sum(-1)
                        + (qd * rows).sum(-1).abs())


def check_bf16_selection(q, table, got_v, got_i, want_v, want_i, what
                         ) -> float:
    """A bf16 stream's top-k against the exact one: each returned item's
    exact score is at least the exact k-th score less its own stream
    error bound and the largest of the exact top k's (an item is chosen
    over a missing top-k item only where its stream score is at least
    that item's). Logs what share of the returned scores also meet
    tests/test_recommend.py's tighter bound, the exact score at the same
    place less 2^-8 |v| + 1e-6, which two items tied in the bf16 stream
    (one ulp, up to 2^-7 |v| apart) can miss, JAX's own top-k too. Returns
    the largest shortfall (<= 0)."""
    e_got = bf16_stream_error(q, table, got_i)
    e_top = bf16_stream_error(q, table, want_i).max(1, keepdim=True).values
    kth = want_v[:, -1:].double()
    short = float((kth - e_got - e_top - got_v.double()).max())
    check(short <= 0.0, f"{what}: a returned score {short:.3e} below the "
          "exact k-th less the bf16 rounding bound")
    tight = float((got_v >= want_v - (want_v.abs() * 2.0 ** -8 + 1e-6))
                  .float().mean())
    log(f"  {what}: every score within the bf16 rounding bound of the "
        f"exact k-th (largest shortfall {short:.3e}, mean bound "
        f"{float((e_got + e_top).mean()):.3e}); {tight:.4f} of them within "
        f"2^-8 |v| + 1e-6 of the exact score at their place")
    return short


def adam_steps(model, leaves, graphs, batch, tc, n) -> list:
    """n training steps of `model` on one batch at keep_rate 1: the whole
    loss, its gradient and a TF1-Adam update of `leaves` in place; the
    losses of each step, checked finite with finite gradients."""
    import torch
    from sagnn_tpu_torch.train.optim import TF1Adam

    opt = TF1Adam(tc.lr, tc.decay, tc.decay_step)
    state = opt.init(leaves)
    out = []
    for i in range(n):
        pre, ssl, grads = loss_and_grads(model, leaves, graphs, batch, tc)
        check(bool(torch.isfinite(pre)) and bool(torch.isfinite(ssl))
              and all(bool(torch.isfinite(g).all())
                      for g in grads.values()),
              f"step {i}: finite losses and gradients")
        opt.step(leaves, grads, state)
        out.append({"preLoss": float(pre), "sslloss": float(ssl)})
    return out


def bf16_mode_phase(f32_cfg, bundle, params, f32_encoding, batch, device
                    ) -> dict:
    """15. The --bf16 model at gowalla width: its config built by the CLI's
    `build_config` from `--data gowalla --bf16` (spmm_exact=False,
    fusion_dtype="bf16", stable_softmax), served by a `Recommender` on
    phase 5's weights. Five encodes (12 segsum_bf16 launches each), bit
    for bit the same; the encode against the f32 encode at JAX's bf16
    bound and against its reference (the bf16 tables summed hop by hop in
    f64, then the same bf16 fusion stack) within BF16_REF_ULPS; at
    keepRate 1 on phase 6's batch, the step's losses against the f32
    step's at JAX's bound (12 + 12 launches), then TRAIN_STEPS_NEW steps
    with TF1 Adam, finite; encode and step ms."""
    import torch
    from sagnn_tpu_torch import main as cli
    from sagnn_tpu_torch.models import selfgnn
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.serve import Recommender

    cfg = cli.build_config(cli.parse_args(
        ["--data", "gowalla", "--bf16", "--spmm_backend", "pallas",
         "--seed", str(PARAM_SEED)]))
    mc, tc = cfg.model, cfg.train
    check((mc.spmm_exact, mc.fusion_dtype, mc.stable_softmax)
          == (False, "bf16", True), "--bf16 sets the throughput mode")
    check(dataclasses.replace(mc, spmm_exact=True, fusion_dtype="f32",
                              stable_softmax=False) == f32_cfg.model,
          "--bf16 changes nothing else")
    nu, ni = bundle.num_users, bundle.num_items
    hops = mc.graph_num * mc.gnn_layer * 2
    out = {"card": gpu_name_and_power()}
    rec = Recommender(cfg, bundle, params, device=device)
    sc.reset_launches()
    fu, fi = rec.encode()
    torch.cuda.synchronize()
    out["launches_encode"] = dict(sc.LAUNCHES)
    expect_launches(out["launches_encode"], "--bf16 encode",
                    segsum_bf16=hops)
    check(fu.dtype == fi.dtype == torch.float32
          and fu.shape == (nu, 64) and fi.shape == (ni, 64),
          "--bf16 encoding shapes and dtype")
    first = torch.cat([fu, fi])
    for i in range(4):
        check(torch.equal(torch.cat(rec.encode()), first),
              f"--bf16 encode {i + 2} of 5: the first encode's bits")
    log("  --bf16 encode: 5 encodes, the same bits")
    f32_fu, f32_fi = f32_encoding
    out["dev_from_f32"] = max(
        check_close(fu, f32_fu, BF16_FUSION_RTOL, BF16_FUSION_ATOL,
                    "--bf16 final_user vs the f32 encode"),
        check_close(fi, f32_fi, BF16_FUSION_RTOL, BF16_FUSION_ATOL,
                    "--bf16 final_item vs the f32 encode"))
    with torch.no_grad():
        uv_ref, iv_ref = bf16_propagation_reference(
            rec.params, rec.graphs, mc, nu, ni)
        ru, ri = selfgnn._temporal_fusion(rec.params, uv_ref.float(),
                                          iv_ref.float(), mc)
    del uv_ref, iv_ref
    out["ulps_vs_reference"] = max(
        check_ulps(fu, ru, BF16_REF_ULPS, "--bf16 final_user vs reference"),
        check_ulps(fi, ri, BF16_REF_ULPS, "--bf16 final_item vs reference"))
    out["encode_ms"] = cuda_ms(rec.encode, iters=5, warmup=1)

    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    bf = selfgnn.SelfGNN(dataclasses.replace(mc, keep_rate=1.0), nu, ni)
    f32 = selfgnn.SelfGNN(dataclasses.replace(f32_cfg.model, keep_rate=1.0),
                          nu, ni)
    sc.reset_launches()
    pre, ssl, grads = loss_and_grads(bf, leaves, rec.graphs, batch, tc)
    torch.cuda.synchronize()
    out["launches_step"] = dict(sc.LAUNCHES)
    expect_launches(out["launches_step"], "--bf16 step", segsum_bf16=hops,
                    segsum_bf16_bwd=hops)
    check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
          "--bf16 step gradients finite")
    pre32, ssl32, _ = loss_and_grads(f32, leaves, rec.graphs, batch, tc)
    check_close(pre.reshape(1), pre32.reshape(1), BF16_FUSION_RTOL, 0.0,
                "--bf16 step preLoss vs the f32 step's")
    check_close(ssl.reshape(1), ssl32.reshape(1), BF16_FUSION_RTOL, 0.0,
                "--bf16 step sslloss vs the f32 step's")
    out["losses_vs_f32"] = {"preLoss": [float(pre), float(pre32)],
                            "sslloss": [float(ssl), float(ssl32)]}
    del grads
    for name, model in (("step", bf), ("f32_step", f32)):
        out[f"{name}_ms"] = cuda_ms(lambda: loss_and_grads(
            model, leaves, rec.graphs, batch, tc), iters=3, warmup=1)
        out[f"{name}_device_ms"] = step_device_ms(lambda: loss_and_grads(
            model, leaves, rec.graphs, batch, tc))
    out["step_losses"] = adam_steps(bf, leaves, rec.graphs, batch, tc,
                                    TRAIN_STEPS_NEW)
    log(f"--bf16 gowalla ({out['card']}): encode {out['encode_ms']:.3f} "
        f"ms; step "
        f"{out['step_ms']:.3f} ms, device {out['step_device_ms']} ms (f32 "
        f"step {out['f32_step_ms']:.3f} ms, device "
        f"{out['f32_step_device_ms']} ms); {TRAIN_STEPS_NEW} Adam steps, "
        f"losses " + ", ".join(f"{x['preLoss']:.4f}"
                               for x in out["step_losses"]))
    return out


def step_device_ms(step, n: int = 3) -> float | None:
    """The device time of one call of `step` (torch.profiler over n calls,
    `profiled_ms`); None where the profiler saw no device events."""
    _wall, by_name = profiled_ms(step, n)
    return sum(by_name.values()) if by_name else None


def per_token_phase(cfg, bundle, params, graphs, batch, device) -> dict:
    """16. Per-token sequence attention at gowalla width (pos_length 200,
    16 heads), in f32 and in bf16 (fusion_dtype): the full-catalog scores
    of SERVE_USERS test users, whose sequences are padded, against an f64
    plain reference of the per-token branch on the same encodings (the
    head q = final_user + leakyReLU(att_user) and its scores in f64);
    TRAIN_STEPS_NEW steps with TF1 Adam at keepRate 1 on phase 6's batch,
    finite; score and step ms."""
    import numpy as np
    import torch
    from sagnn_tpu_torch.data.sampler import user_sequences
    from sagnn_tpu_torch.models import selfgnn
    from sagnn_tpu_torch.models.layers import leaky_relu
    from sagnn_tpu_torch.ops import spmm_cuda as sc

    nu, ni = bundle.num_users, bundle.num_items
    hops = cfg.model.graph_num * cfg.model.gnn_layer * 2
    users = np.asarray(bundle.tst_usrs[:SERVE_USERS])
    seq, mask = user_sequences(bundle, users, cfg.model.pos_length)
    check(bool((mask == 0).any()) and bool((mask.sum(1) > 0).all()),
          "per-token requests: padded, non-empty sequences")
    uid, seq_t, mask_t = (torch.from_numpy(a).to(device)
                          for a in (users, seq, mask))
    p64 = {k: v.detach().double() for k, v in params.items()}
    out = {"card": gpu_name_and_power()}
    for dtype in ("f32", "bf16"):
        mc = dataclasses.replace(cfg.model, per_token_seq_attention=True,
                                 fusion_dtype=dtype)
        check((mc.pos_length, mc.num_heads) == (200, 16),
              "per-token widths")
        model = selfgnn.SelfGNN(mc, nu, ni)
        fu, fi, _, _ = model.encode(params, graphs)
        scores = model.score_all_items(params, fu, fi, uid, seq_t, mask_t)
        torch.cuda.synchronize()
        with torch.no_grad():
            att64 = selfgnn._sequence_branch(
                p64, fi.double(), seq_t, mask_t.double(),
                dataclasses.replace(mc, fusion_dtype="f32"))
            q64 = fu[uid.long()].double() + leaky_relu(att64, mc.leaky)
            want = q64 @ fi.double().T
        rec = {}
        if dtype == "f32":
            scale = float(want.abs().max())
            rec["max_abs_err"] = check_close(
                scores, want, PER_TOKEN_RTOL, PER_TOKEN_ATOL_SHARE * scale,
                "per-token f32 scores vs the f64 reference")
        else:
            rec["ulps"] = check_ulps(scores, want, PER_TOKEN_BF16_ULPS,
                                     "per-token bf16 scores vs the f64 "
                                     "reference")
        del att64, q64, want
        rec["score_ms"] = cuda_ms(lambda: model.score_all_items(
            params, fu, fi, uid, seq_t, mask_t), iters=5, warmup=1)
        step_model = selfgnn.SelfGNN(dataclasses.replace(mc, keep_rate=1.0),
                                     nu, ni)
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sc.reset_launches()
        rec["step_losses"] = adam_steps(step_model, leaves, graphs, batch,
                                        cfg.train, TRAIN_STEPS_NEW)
        torch.cuda.synchronize()
        rec["launches_steps"] = {k: v for k, v in sc.LAUNCHES.items() if v}
        expect_launches(dict(sc.LAUNCHES), f"per-token {dtype} steps",
                        segsum_f32=hops * TRAIN_STEPS_NEW,
                        segsum_f32_bwd=hops * TRAIN_STEPS_NEW)
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

        def step():
            return loss_and_grads(step_model, leaves, graphs, batch,
                                  cfg.train)

        rec["step_ms"] = cuda_ms(step, iters=3, warmup=1)
        rec["step_device_ms"] = step_device_ms(step)
        log(f"per-token {dtype} ({out['card']}): scores of {len(users)} "
            f"users x {ni} items "
            f"{rec['score_ms']:.3f} ms; step {rec['step_ms']:.3f} ms, device "
            f"{rec['step_device_ms']} ms; peak memory of the steps "
            f"{rec['peak_memory_gb']:.2f} GB; losses "
            + ", ".join(f"{x['preLoss']:.4f}" for x in rec["step_losses"]))
        out[dtype] = rec
        del leaves, fu, fi, scores
    return out


def bf16_b4096_config():
    """scripts/bench_1m.py's bf16_b4096 recipe (`RECIPES`, :35-41) on the
    flagship's model: batch 4096, remat_propagation, fusion_chunk_rows
    32,768, fusion_dtype "bf16", the stable softmax and bf16 tables; no
    spmm_fold_gather."""
    cfg = flagship_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, fusion_chunk_rows=32_768,
                                  fusion_dtype="bf16", stable_softmax=True,
                                  spmm_exact=False, spmm_fold_gather=False),
        train=dataclasses.replace(cfg.train, batch=4096))


def flagship_bf16_phase(bundle, device) -> dict:
    """17. The flagship's bf16_b4096 recipe on phase 12's bundle: a
    `Trainer` (shard rows resolved to FLAGSHIP_SHARD_ROWS); the encode
    (84 segsum_acc_bf16 launches), finite; FLAGSHIP_BF16_STEPS
    synchronised `train_step`s at keepRate 0.5 (K3 bf16 launches counted:
    forward, recompute, backward), finite, with the peak device memory,
    then a profiler pass over two more (device time, busy share); the
    bf16 stream's `chunked_topk` for SERVE_USERS users, top 10 of the
    catalog, against the exact f32 one (TOPK_RERANK_RTOL and
    `check_bf16_selection`), both timed; a streamed full-sort evaluation
    of the test users. Returns its record and, for phase 20, the
    queries, item encodings and sequences of the top-k users."""
    import numpy as np
    import torch
    from sagnn_tpu_torch.data.sampler import user_sequences
    from sagnn_tpu_torch.models.selfgnn import chunked_topk
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.ops.chunking import AUTO_CHUNK_ROWS
    from sagnn_tpu_torch.train.trainer import Trainer

    cfg = bf16_b4096_config()
    tc = cfg.train
    nu, ni = bundle.num_users, bundle.num_items
    out = {"recipe": "bf16_b4096", "batch": tc.batch,
           "card": gpu_name_and_power()}
    root = tempfile.mkdtemp()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, bundle, ckpt_root=root, device=device)
    torch.cuda.synchronize()
    out["trainer_setup_s"] = time.perf_counter() - t0
    mc = trainer.cfg.model
    check(mc.spmm_src_shard_rows == FLAGSHIP_SHARD_ROWS,
          f"bf16_b4096 shard rows {mc.spmm_src_shard_rows}")
    ss = trainer.graphs["plans_ss"]
    per_encode = mc.graph_num * mc.gnn_layer * (ss["u_ptr"].shape[1]
                                                + ss["i_ptr"].shape[1])
    params = trainer.state["params"]
    sc.reset_launches()
    fu, fi, _, _ = trainer.model.encode(params, trainer.graphs)
    torch.cuda.synchronize()
    out["launches_encode"] = {k: v for k, v in sc.LAUNCHES.items() if v}
    expect_launches(dict(sc.LAUNCHES), "bf16_b4096 encode",
                    segsum_acc_bf16=per_encode)
    check(fu.shape == (nu, 64) and fi.shape == (ni, 64)
          and bool(torch.isfinite(fu).all())
          and bool(torch.isfinite(fi).all()), "bf16_b4096 encode finite")
    out["encode_ms"] = cuda_ms(
        lambda: trainer.model.encode(params, trainer.graphs), iters=3,
        warmup=1)
    log(f"bf16_b4096 ({out['card']}): Trainer set-up "
        f"{out['trainer_setup_s']:.1f} s; "
        f"encode {out['encode_ms']:.2f} ms ({per_encode} K3 bf16 "
        f"launches)")

    ids = trainer.sampler.epoch_user_ids(tc.trn_num)
    torch.cuda.synchronize()
    # what the earlier phases still hold counts in the peak; it is logged
    out["memory_before_steps_gb"] = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    sc.reset_launches()
    step_s, sample_ms, losses = [], [], []
    for i in range(FLAGSHIP_BF16_STEPS):
        t0 = time.perf_counter()
        b = trainer.sampler.train_batch(ids[i * tc.batch:(i + 1) * tc.batch])
        sample_ms.append((time.perf_counter() - t0) * 1e3)
        b = b.to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = trainer.train_step(b)
        losses.append({k: float(v) for k, v in stats.items()})
        step_s.append(time.perf_counter() - t0)
    out["launches_steps"] = {k: v for k, v in sc.LAUNCHES.items() if v}
    expect_launches(dict(sc.LAUNCHES), "bf16_b4096 Trainer steps",
                    segsum_acc_bf16=2 * per_encode * FLAGSHIP_BF16_STEPS,
                    segsum_acc_bf16_bwd=per_encode * FLAGSHIP_BF16_STEPS)
    check(all(math.isfinite(v) for x in losses for v in x.values()),
          "bf16_b4096 Trainer losses finite")
    check(all(bool(torch.isfinite(v).all()) for v in params.values()),
          "bf16_b4096 params finite after the steps")
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["trainer_step_s"] = step_s
    out["trainer_losses"] = losses
    out["host_sample_ms"] = sample_ms
    out["profile"] = profile_steps(lambda: trainer.train_step(b), n=2)
    log(f"bf16_b4096 Trainer steps ({out['card']}; batch {tc.batch}, "
        f"keepRate "
        f"{mc.keep_rate}): " + ", ".join(f"{x:.3f}" for x in step_s)
        + f" s; peak device memory {out['peak_memory_gb']:.2f} GB (of it "
        f"{out['memory_before_steps_gb']:.2f} GB held before the steps); "
        f"host sampling {sum(sample_ms) / len(sample_ms):.1f} ms per batch")

    # serving: the bf16 stream's top-k against the exact one
    users = np.asarray(bundle.tst_usrs[:SERVE_USERS])
    seq, mask = user_sequences(bundle, users, mc.pos_length)
    with torch.no_grad():
        fu, fi, _, _ = trainer.model.encode(params, trainer.graphs)
        q = trainer.model.serving_queries(
            params, fu, fi, *(torch.from_numpy(a).to(device)
                              for a in (users, seq, mask)))

        def exact():
            return chunked_topk(q, fi, ni, 10, AUTO_CHUNK_ROWS)

        def stream():
            return chunked_topk(q, fi, ni, 10, AUTO_CHUNK_ROWS,
                                score_dtype=torch.bfloat16)

        want_v, want_i = exact()
        got_v, got_i = stream()
        rescored = torch.einsum("bd,bkd->bk", q, fi[got_i])
    check(got_v.dtype == torch.float32 and got_v.shape == (len(users), 10)
          and bool((got_v[:, :-1] >= got_v[:, 1:]).all()),
          "bf16 top-k: f32, sorted")
    out["topk_rerank_err"] = check_close(
        got_v, rescored, TOPK_RERANK_RTOL, 0.0,
        "bf16 top-k scores vs the f32 scores of its ids")
    out["topk_short_of_bound"] = check_bf16_selection(
        q, fi, got_v, got_i, want_v, want_i, "bf16_b4096 top-k")
    same = float(sum(len(set(a) & set(b)) for a, b in zip(
        got_i.tolist(), want_i.tolist())) / got_i.numel())
    out["topk_same_ids_share"] = same
    out["topk_exact_ms"] = cuda_ms(exact, iters=5, warmup=1)
    out["topk_bf16_ms"] = cuda_ms(stream, iters=5, warmup=1)
    log(f"bf16_b4096 top-10 of {ni} for {len(users)} users ({out['card']})"
        f": exact f32 "
        f"{out['topk_exact_ms']:.3f} ms, bf16 stream + rerank "
        f"{out['topk_bf16_ms']:.3f} ms; {same:.4f} of the ids the exact "
        f"ones")
    del fu
    catalog = (q, fi, torch.from_numpy(seq).to(device),
               torch.from_numpy(mask).to(device))
    t0 = time.perf_counter()
    metrics = trainer.test_epoch(full_sort=True)
    torch.cuda.synchronize()
    out["full_sort_s"] = time.perf_counter() - t0
    out["full_sort_users"] = len(bundle.tst_usrs)
    out["full_sort_metrics"] = {k: metrics[k] for k in ("HR@10", "NDCG@10")}
    for k, v in metrics.items():
        check(math.isfinite(v) and 0.0 <= v <= 1.0,
              f"bf16_b4096 full-sort metric {k}={v}")
    log(f"bf16_b4096 full-sort evaluate over {out['full_sort_users']} users"
        f" x {ni} items ({out['card']}): {out['full_sort_s']:.2f} s")
    shutil.rmtree(root, ignore_errors=True)
    return out, catalog


def tf1_import_phase(device) -> dict:
    """18. The executed TF1 reference's weights (TF1_FIXTURE) imported by
    the port's `npz_getter` and `map_reference_params`, served by a
    `Recommender` on the card ("pallas", K1): the candidate scores of the
    reference's test batch against the reference's (rtol 1e-4, atol
    1e-5), HR exact and NDCG at rtol 1e-6 (tests/test_torch_fixture.py's
    tolerances); then `Trainer.load_imported_params` and one step, finite."""
    import numpy as np
    import torch
    from sagnn_tpu_torch.config import Config, ModelConfig, TrainConfig
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.serve import Recommender
    from sagnn_tpu_torch.train.import_tf1 import (map_reference_params,
                                                  npz_getter)
    from sagnn_tpu_torch.train.metrics import topk_metrics
    from sagnn_tpu_torch.train.trainer import Trainer

    z = np.load(os.path.join(ROOT, TF1_FIXTURE))
    fx = json.loads(bytes(z["cfg/json"]).decode())
    mc = ModelConfig(graph_num=int(fx["graphNum"]),
                     gnn_layer=int(fx["gnn_layer"]),
                     att_layer=int(fx["att_layer"]), latdim=int(fx["latdim"]),
                     num_heads=int(fx["num_attention_heads"]),
                     ssldim=int(fx["ssldim"]),
                     pos_length=int(fx["pos_length"]),
                     leaky=float(fx["leaky"]), keep_rate=1.0,
                     spmm_backend="pallas")
    tc = TrainConfig(batch=int(fx["batch"]), samp_num=int(fx["samp_num"]),
                     ssl_num=int(fx["sslNum"]), trn_num=int(fx["trnNum"]),
                     test_size=int(fx["testSize"]), reg=float(fx["reg"]),
                     ssl_reg=float(fx["ssl_reg"]), lr=float(fx["lr"]))
    cfg = Config(model=mc, train=tc)
    params = map_reference_params(npz_getter(z), mc)
    bundle = synthetic_dataset(num_users=fx["num_users"],
                               num_items=fx["num_items"],
                               graph_num=mc.graph_num, test_size=8,
                               seed=fx["bundle_seed"])
    rec = Recommender(cfg, bundle, params, device=device)
    sc.reset_launches()
    fu, fi = rec.encode()
    torch.cuda.synchronize()
    out = {"card": gpu_name_and_power(),
           "launches_encode": {k: v for k, v in sc.LAUNCHES.items() if v}}
    expect_launches(dict(sc.LAUNCHES), "TF1 fixture encode",
                    segsum_f32=mc.graph_num * mc.gnn_layer * 2)

    def t(name):
        return torch.from_numpy(z[name]).to(device)

    scores = rec.model.score_with_encodings(
        rec.params, fu, fi, t("tst/user_ids"), t("tst/cands"),
        t("tst/sequence"), t("tst/mask"))
    out["scores_max_abs_err"] = check_close(
        scores, torch.from_numpy(z["tst/preds"]).to(device), 1e-4, 1e-5,
        "TF1 fixture candidate scores vs the reference's")
    m = topk_metrics(scores, ks=(5, 10, 20))
    want = dict(zip(("HR@10", "NDCG@10", "HR@5", "NDCG@5", "HR@20",
                     "NDCG@20"), (float(v) for v in z["tst/metrics"])))
    for k, w in want.items():
        got = float(m[k])
        ok = (abs(got - w) <= 1e-9 if k.startswith("HR")
              else abs(got - w) <= 1e-6 * abs(w))
        check(ok, f"TF1 fixture {k}: {got} vs the reference's {w}")
    out["metrics"] = {k: float(m[k]) for k in want}
    log(f"TF1 fixture on the card ({out['card']}): scores within rtol 1e-4 "
        f"/ atol 1e-5 "
        f"(max abs err {out['scores_max_abs_err']:.3e}); HR@10 "
        f"{out['metrics']['HR@10']:.4f}, NDCG@10 "
        f"{out['metrics']['NDCG@10']:.6f} = the reference's")
    root = tempfile.mkdtemp()
    trainer = Trainer(cfg, bundle, ckpt_root=root, device=device)
    trainer.load_imported_params(params)
    check(all(torch.equal(trainer.state["params"][k].detach().cpu(), v)
              for k, v in params.items()), "imported params installed")
    ids = trainer.sampler.epoch_user_ids(tc.trn_num)
    stats = trainer.train_step(
        trainer.sampler.train_batch(ids[:tc.batch]).to(device))
    out["step_losses"] = {k: float(v) for k, v in stats.items()}
    check(all(math.isfinite(v) for v in out["step_losses"].values())
          and trainer.state["step"] == 1, "imported Trainer step finite")
    log(f"TF1 fixture Trainer: one step from the imported weights, losses "
        f"{out['step_losses']}")
    shutil.rmtree(root, ignore_errors=True)
    return out


# phases 19-21, the user path. 19: a raw user,item,timestamp log (power-law
# popularity and activity, a year of timestamps) preprocessed by the
# port's CLI with a 5-core, trained at gowalla width under the wedge
# watchdog (`build_supervisor`, as `main --supervise` builds it, polled
# every SUPERVISOR_POLL_S instead of the CLI's 15 s) with the child
# SIGSTOPped at its first step line, and its checkpoint served
RAW_USERS = 49_152
RAW_ITEMS = 40_960
RAW_EVENTS = 1_500_000
RAW_SEED = 11
RAW_CORE = 5
USER_PATH_EPOCHS = 3
USER_PATH_TRN_NUM = 10_240      # 20 steps of 512
WEDGE_SECS = 10.0               # --supervise_wedge_secs
SUPERVISOR_POLL_S = 1.0
CATALOG_SHARDS = 4
CLI_SERVE_USERS = 3
# a child blocked on a long device op: seconds of the spin kernel it waits
# on (torch.cuda._sleep), once through synchronize and once through .item()
BLOCKED_SLEEP_S = 3.0
BLOCKED_CHILD = """
import json, sys, time, torch
s = float(sys.argv[1])
torch.ones(1, device="cuda").sum().item()
out = {}
for how in ("synchronize", "item"):
    x = torch.ones(1, device="cuda")
    c0, t0 = time.process_time(), time.perf_counter()
    torch.cuda._sleep(int(s * 2e9))
    torch.cuda.synchronize() if how == "synchronize" else x.sum().item()
    out[how] = {"wall_s": time.perf_counter() - t0,
                "cpu_s": time.process_time() - c0}
print(json.dumps(out))
"""
# 20: sharded against single-device top-k. Scores within rtol/atol 1e-5
# (JAX's bound, tests/test_serving_sharded.py); ids equal wherever the
# single-device scores leave a gap wider than that around them
SHARDED_TOL = 1e-5
SHARDED_CHUNK_ROWS = 4_096


def write_raw_log(path: str) -> int:
    """A seeded raw interaction log as `user,item,timestamp` CSV: users and
    items drawn with power-law weights (1/(rank+100)^0.5 and
    1/(rank+20)^0.9), ids shuffled, timestamps uniform over 2010."""
    import numpy as np
    rng = np.random.default_rng(RAW_SEED)
    pu = 1.0 / (np.arange(RAW_USERS) + 100.0) ** 0.5
    pi = 1.0 / (np.arange(RAW_ITEMS) + 20.0) ** 0.9
    u = rng.permutation(RAW_USERS)[rng.choice(RAW_USERS, RAW_EVENTS,
                                              p=pu / pu.sum())]
    i = rng.permutation(RAW_ITEMS)[rng.choice(RAW_ITEMS, RAW_EVENTS,
                                              p=pi / pi.sum())]
    t = rng.integers(1_262_304_000, 1_293_840_000, RAW_EVENTS)
    np.savetxt(path, np.stack([u, i, t], 1), fmt="%d", delimiter=",",
               header="user,item,timestamp", comments="")
    return RAW_EVENTS


def check_same_topk(got, want, what) -> dict:
    """got and want are (scores [B, k], ids [B, k]); want is one longer
    (top k+1) so the k-th score's gap below is known. Scores within
    SHARDED_TOL; ids equal wherever want's score is more than the tolerance
    from both neighbours; every id a real item. Returns the max abs error
    and the share of places held to equal ids."""
    import torch
    gv, gi = got
    wv, wi = want
    k = gv.shape[1]
    err = check_close(gv, wv[:, :k], SHARDED_TOL, SHARDED_TOL, what)
    w = wv.double()
    inf = torch.full_like(w[:, :1], math.inf)
    w = torch.cat([inf, w], 1)
    gap = torch.minimum((w[:, 1:k + 1] - w[:, :k]).abs(),
                        (w[:, 2:k + 2] - w[:, 1:k + 1]).abs())
    clear = gap > SHARDED_TOL * (1 + w[:, 1:k + 1].abs())
    check(bool((gi.to(wi.device)[clear] == wi[:, :k][clear]).all()),
          f"{what}: ids differ away from ties")
    return {"max_abs_err": err, "ids_held_share": float(clear.float().mean())}


def blocked_child_cpu(proc) -> dict:
    """The blocked child's JSON line (started by `user_path_phase`)."""
    out, err = proc.communicate(timeout=300)
    check(proc.returncode == 0, f"blocked child: {err[-2000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    for how, r in res.items():
        r["cpu_share"] = r["cpu_s"] / r["wall_s"]
        log(f"a child blocked {r['wall_s']:.2f} s on a device op through "
            f"{how} burns {r['cpu_s']:.2f} CPU-s ({r['cpu_share']:.2f} of "
            f"its wall time)")
    return res


def user_path_phase(device) -> dict:
    """19. The user's life cycle with the port's own tools, at the gowalla
    preset's widths: a raw CSV of RAW_EVENTS interactions
    (`write_raw_log`) through `python -m sagnn_tpu_torch.preprocess`
    (5-core, 3 intervals, 999 negatives), timed, its counts logged;
    training on the result (`main --data gowalla --spmm_backend pallas`,
    USER_PATH_EPOCHS epochs of USER_PATH_TRN_NUM users) under the
    watchdog that `main --supervise --supervise_wedge_secs WEDGE_SECS`
    builds (`build_supervisor`), polled every SUPERVISOR_POLL_S, with the
    child SIGSTOPped once its log shows a step line: the supervisor exits
    0 after one recovery (WEDGE, the preemption checkpoint, the CUDA
    probe, the resume), no staging file left, history.json through the
    last epoch. Then the checkpoint served in this process by
    `Recommender.from_checkpoint` on one device and over CATALOG_SHARDS
    catalog shards on the card (12 K1 launches per encode), each encode
    held against the plain backend on this graph (its propagation summed
    in f64, phase 5's tolerances), top-10 for SERVE_USERS users held
    equal, and by the serve CLI in a subprocess.
    Logged, not checked: the CPU a child burns while blocked on a device
    op (`blocked_child_cpu`)."""
    import signal
    import threading

    import numpy as np
    import torch
    from sagnn_tpu_torch import main as tmain
    from sagnn_tpu_torch.data.io import load_dataset
    from sagnn_tpu_torch.data.sampler import user_sequences
    from sagnn_tpu_torch.models.selfgnn import (_interval_propagation,
                                                _temporal_fusion)
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.serve import Recommender, catalog_mesh
    from sagnn_tpu_torch.train.supervisor import build_supervisor

    out = {"card": gpu_name_and_power()}
    work = tempfile.mkdtemp()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    blocked = subprocess.Popen(
        [sys.executable, "-c", BLOCKED_CHILD, str(BLOCKED_SLEEP_S)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    sup, serve_cli = None, None
    try:
        t0 = time.perf_counter()
        csv = os.path.join(work, "raw.csv")
        write_raw_log(csv)
        out["raw_log_s"] = time.perf_counter() - t0
        data_dir = os.path.join(work, "Datasets")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "sagnn_tpu_torch.preprocess", "--csv",
             csv, "--out", os.path.join(data_dir, "gowalla"), "--graph_num",
             "3", "--user_core", str(RAW_CORE), "--item_core",
             str(RAW_CORE)], capture_output=True, text=True, timeout=600,
            cwd=ROOT, env=env)
        out["preprocess_s"] = time.perf_counter() - t0
        check(r.returncode == 0, f"preprocess CLI: {r.stderr[-2000:]}")
        for line in r.stdout.splitlines():
            log(f"  preprocess: {line}")
        after = [x for x in r.stdout.splitlines() if "after filtering" in x]
        check(len(after) == 1, "preprocess logged its k-core counts")
        nums = [int(x) for x in re.findall(r"(\d+) (?:users|items|interval)",
                                           after[0])]
        out["kcore"] = dict(zip(("users", "items", "interval_edges"), nums))
        log(f"preprocess CLI: {RAW_EVENTS} events -> {out['kcore']} in "
            f"{out['preprocess_s']:.1f} s (CSV written in "
            f"{out['raw_log_s']:.1f} s)")

        ckpt_root = os.path.join(work, "Models")
        # the entry points run on the card unless asked for the CPU (a
        # rehearsal of this phase without a card)
        on = [] if device.type == "cuda" else ["--device", "cpu"]
        raw = on + ["--data", "gowalla", "--data_dir", data_dir,
               "--spmm_backend", "pallas", "--epoch", str(USER_PATH_EPOCHS),
               "--trnNum", str(USER_PATH_TRN_NUM), "--tstEpoch", "1",
               "--ckpt_root", ckpt_root, "--supervise",
               "--supervise_wedge_secs", str(WEDGE_SECS)]
        ns = tmain.parse_args(raw)
        ns.save_path = tmain.build_config(ns).train.save_path
        sup = build_supervisor(ns, raw)
        sup.check_every = SUPERVISOR_POLL_S
        result = {}
        runner = threading.Thread(
            target=lambda: result.update(rc=sup.run()), daemon=True)
        t0 = time.perf_counter()
        runner.start()
        stopped = None
        while stopped is None and runner.is_alive() \
                and time.perf_counter() - t0 < 300:
            time.sleep(0.05)
            pids = [int(m.group(1)) for m in (
                re.search(r"launched pid (\d+)", e) for e in sup.events)
                if m]
            if pids and os.path.exists(sup.log_path):
                with open(sup.log_path) as f:
                    if "Step " in f.read():
                        os.kill(pids[0], signal.SIGSTOP)
                        stopped = time.perf_counter() - t0
        check(stopped is not None, "the supervised child logged a step")
        log(f"supervised child SIGSTOPped {stopped:.1f} s after launch")
        runner.join(600)
        check(not runner.is_alive(), "the supervisor finished in 600 s")
        out["supervised_s"] = time.perf_counter() - t0
        out["stopped_at_s"] = stopped
        with open(sup.log_path) as f:
            text = f.read()
        events = "\n".join(sup.events)
        for line in text.replace("\r", "\n").splitlines()[-8:]:
            log(f"  train.log: {line.strip()}")
        out["supervisor_rc"] = result.get("rc")
        out["recoveries"] = sup.recoveries
        out["supervisor_events"] = sup.events
        check(result.get("rc") == 0 and sup.recoveries == 1,
              f"supervisor rc {result.get('rc')}, {sup.recoveries} "
              "recoveries (want 0 and 1)")
        check("WEDGE" in events and ("relay probe ok" in events
                                     or device.type != "cuda"),
              "the wedge and the CUDA relay probe in the events")
        check("writing preemption checkpoint" in text
              and "Model Loaded, resuming at epoch" in text,
              "the preemption checkpoint and the resume in train.log")
        left = [f for f in os.listdir(sup.ckpt_dir) if f.endswith(".tmp")]
        check(not left, f"staging files left: {left}")
        with open(os.path.join(sup.ckpt_dir, "history.json")) as f:
            hist = json.load(f)
        out["history_epochs"] = len(hist["TrainLoss"])
        out["test_ndcg"] = hist["TestNDCG"]
        check(len(hist["TrainLoss"]) == USER_PATH_EPOCHS
              and f"Epoch {USER_PATH_EPOCHS - 1}/{USER_PATH_EPOCHS}, Train"
              in text, f"history.json holds {len(hist['TrainLoss'])} "
              f"epochs, want {USER_PATH_EPOCHS}")
        log(f"supervised training ({out['card']}): rc 0, 1 recovery, "
            f"{out['supervised_s']:.1f} s; test NDCG by epoch "
            f"{hist['TestNDCG']}")

        bundle = load_dataset(os.path.join(data_dir, "gowalla"))
        users = np.asarray(bundle.tst_usrs[:SERVE_USERS])
        serve_cli_users = [int(u) for u in users[:CLI_SERVE_USERS]]
        serve_cli = subprocess.Popen(
            [sys.executable, "-m", "sagnn_tpu_torch.serve"] + on + [
             "--data", "gowalla", "--data_dir", data_dir, "--ckpt_root",
             ckpt_root,
             "--save_path", ns.save_path, "--k", "10", "--users"]
            + [str(u) for u in serve_cli_users], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
        t0 = time.perf_counter()
        results, launches = {}, {}
        for shards in (0, CATALOG_SHARDS):
            mesh = (catalog_mesh(shards, device) if shards else None)
            rec = Recommender.from_checkpoint(ckpt_root, ns.save_path,
                                              bundle, device=device,
                                              catalog_mesh=mesh)
            check(rec.cfg.model.spmm_backend == "pallas",
                  "the checkpoint's config serves the kernel")
            sc.reset_launches()
            fu, fi = rec.encode()
            torch.cuda.synchronize()
            launches[shards] = dict(sc.LAUNCHES)
            expect_launches(launches[shards], f"checkpoint encode "
                            f"({shards} shards)", segsum_f32=12)
            if not shards:
                # the encode on this graph against the plain ("xla")
                # backend's propagation summed in f64, then the same
                # fusion stack in f32, at phase 5's tolerances
                mc = rec.cfg.model
                nu, ni = bundle.num_users, bundle.num_items
                p64 = dict(rec.params)
                for key in ("reg/u_embed", "reg/i_embed"):
                    p64[key] = p64[key].double()
                uv64, iv64 = _interval_propagation(
                    p64, rec.graphs,
                    dataclasses.replace(mc, spmm_backend="xla"), nu, ni)
                uv, iv = _interval_propagation(rec.params, rec.graphs, mc,
                                               nu, ni)
                ref = _temporal_fusion(rec.params, uv64.float(),
                                       iv64.float(), mc)
                torch.cuda.synchronize()
                check_close(uv, uv64, 1e-5, 1e-5,
                            "checkpoint user_vec kernel vs plain f64")
                check_close(iv, iv64, 1e-5, 1e-5,
                            "checkpoint item_vec kernel vs plain f64")
                del uv64, iv64, uv, iv, p64
            out[f"encode_vs_plain_{shards}_shards"] = max(
                check_close(fu, ref[0], 1e-4, 1e-5, f"checkpoint final_user "
                            f"kernel vs plain ({shards} shards)"),
                check_close(fi, ref[1], 1e-4, 1e-5, f"checkpoint final_item "
                            f"kernel vs plain ({shards} shards)"))
            del fu, fi
            results[shards] = rec.recommend(users, k=10)
            if not shards:
                want = rec.recommend(users, k=11)
                seq, mask = user_sequences(bundle, users,
                                           rec.cfg.model.pos_length)
            torch.cuda.synchronize()
            del rec
        out["serve_setup_s"] = time.perf_counter() - t0
        out["launches_encode"] = {k: v for k, v in launches[0].items() if v}
        out["sharded_vs_single"] = check_same_topk(
            results[CATALOG_SHARDS], want,
            f"checkpoint top-10, {CATALOG_SHARDS} shards vs one device")
        v, i = results[0]
        check(bool(torch.isfinite(v).all())
              and int(i.max()) < bundle.num_items, "served top-10")
        for b in range(len(users)):
            seen = set(seq[b][mask[b] > 0].tolist())
            check(not seen & set(i[b].tolist()), "seen item served")
        out_cli, err_cli = serve_cli.communicate(timeout=600)
        check(serve_cli.returncode == 0, f"serve CLI: {err_cli[-2000:]}")
        lines = [json.loads(x) for x in out_cli.strip().splitlines()]
        check([x["user"] for x in lines] == serve_cli_users
              and all(x["items"] == i[b].tolist()
                      for b, x in enumerate(lines)),
              "the serve CLI's top-10 is the in-process one")
        log(f"checkpoint served ({out['card']}): 12 K1 launches per "
            f"encode, top-10 for {len(users)} users on one device and "
            f"over {CATALOG_SHARDS} shards agree "
            f"({out['sharded_vs_single']}); the serve CLI printed "
            f"{len(lines)} JSON lines")
        out["blocked_child"] = blocked_child_cpu(blocked)
    finally:
        if blocked.poll() is None:
            blocked.kill()
            blocked.wait()
        if serve_cli is not None and serve_cli.poll() is None:
            serve_cli.kill()
            serve_cli.wait()
        shutil.rmtree(work, ignore_errors=True)
    return out


def sharded_serving_phase(catalogs, device) -> dict:
    """20. Catalog-sharded top-10 at scale on a one-card mesh of
    CATALOG_SHARDS ranks, against the single-device path on the same
    queries (`check_same_topk`), both timed with CUDA events: phase 5's
    gowalla encodings (40,960 items) dense and streamed in
    SHARDED_CHUNK_ROWS chunks against the dense top-k; the flagship's
    786,432 items (196,608 rows per rank, streamed by the auto policy)
    against `chunked_topk`. Each user's own items are excluded."""
    import torch
    from sagnn_tpu_torch.models.selfgnn import chunked_topk, topk_descending
    from sagnn_tpu_torch.ops.chunking import (AUTO_CHUNK_ROWS,
                                              auto_chunk_rows,
                                              scatter_local_mask)
    from sagnn_tpu_torch.parallel.mesh import make_mesh
    from sagnn_tpu_torch.parallel.serving import (pad_catalog, shard_catalog,
                                                  sharded_topk)

    out = {"card": gpu_name_and_power(), "shards": CATALOG_SHARDS}
    mesh = make_mesh(data=1, model=CATALOG_SHARDS,
                     devices=[device] * CATALOG_SHARDS)
    for name, (q, fi, seq, mask), chunks in catalogs:
        ni = fi.shape[0]
        table = shard_catalog(mesh, pad_catalog(fi, CATALOG_SHARDS))
        single_chunk = auto_chunk_rows(ni)

        def single(k=10):
            if single_chunk > 0:
                return chunked_topk(q, fi, ni, k, AUTO_CHUNK_ROWS,
                                    seen_seq=seq, seen_mask=mask)
            scores = (q @ fi.T).masked_fill(
                scatter_local_mask(seq, 0, ni, valid=mask), float("-inf"))
            return topk_descending(scores, k)

        want = single(11)
        res = {"items": ni, "rows_per_rank": table[0].shape[0],
               "single_ms": cuda_ms(single, iters=5, warmup=1)}
        for chunk in chunks:
            def sharded(chunk=chunk):
                return sharded_topk(mesh, q, table, ni, 10, seen_seq=seq,
                                    seen_mask=mask, chunk_rows=chunk)
            got = sharded()
            torch.cuda.synchronize()
            mode = {0: "auto", -1: "dense"}.get(chunk, f"chunk {chunk}")
            res[mode] = check_same_topk(
                got, want, f"{name} sharded ({mode}) vs single device")
            res[mode]["ms"] = cuda_ms(sharded, iters=5, warmup=1)
            log(f"{name} top-10 of {ni} for {q.shape[0]} users over "
                f"{CATALOG_SHARDS} ranks ({mode}, {table[0].shape[0]} rows "
                f"each; {out['card']}): {res[mode]['ms']:.3f} ms; single "
                f"device {res['single_ms']:.3f} ms")
        out[name] = res
        del table
    return out


def profiler_trace_phase(cfg, bundle, device) -> dict:
    """21. `main.profile_epoch` (what `--profile_dir` runs) on a gowalla
    `Trainer`: one train_epoch under `utils.profiling.trace`, then the
    state and RNG restored. Checks: the trace file parses as JSON with CPU
    op events; params, Adam moments, counts and the RNG state after it
    bit-equal to a snapshot taken before; its K1 launches (12 + 12 per
    step); a positive edge rate (`EdgeRateCounter`). Logged: the trace's
    CUDA kernel events and K1 symbols among them."""
    import copy
    import glob

    import torch
    from sagnn_tpu_torch import main as tmain
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.train.trainer import Trainer
    from sagnn_tpu_torch.utils.profiling import EdgeRateCounter

    out = {"card": gpu_name_and_power()}
    work = tempfile.mkdtemp()
    try:
        trainer = Trainer(cfg.replace(train=dataclasses.replace(
            cfg.train, save_path="trace")), bundle, ckpt_root=work,
            device=device)
        steps = -(-cfg.train.trn_num // cfg.train.batch)
        snap = copy.deepcopy(trainer.state)
        rng = trainer.capture_rng_state(0)
        logdir = os.path.join(work, "trace")
        sc.reset_launches()
        t0 = time.perf_counter()
        tmain.profile_epoch(trainer, logdir)
        torch.cuda.synchronize()
        out["profiled_epoch_s"] = time.perf_counter() - t0
        out["launches"] = {k: v for k, v in sc.LAUNCHES.items() if v}
        expect_launches(dict(sc.LAUNCHES), "profiled epoch",
                        segsum_f32=12 * steps, segsum_f32_bwd=12 * steps)
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        check(len(files) == 1, f"one trace file under {logdir}: {files}")
        out["trace_mb"] = os.path.getsize(files[0]) / 1e6
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        cats = {}
        for e in events:
            cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        check(cats.get("cpu_op", 0) > 0, "the trace holds CPU op events")
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        out["cpu_op_events"] = cats["cpu_op"]
        out["cuda_kernel_events"] = len(kernels)
        out["k1_kernel_events"] = sum("segsum_pieces_kernel" in k
                                      for k in kernels)
        st = trainer.state
        same = (st["step"] == snap["step"]
                and st["opt_state"].count == snap["opt_state"].count
                and all(torch.equal(st[part][k].detach(),
                                    snap[part][k].detach())
                        for part in ("params",) for k in snap["params"])
                and all(torch.equal(getattr(st["opt_state"], m)[k],
                                    getattr(snap["opt_state"], m)[k])
                        for m in ("mu", "nu") for k in snap["params"]))
        check(same, "state after the profiled epoch bit-equal to before")
        check(trainer.capture_rng_state(0) == rng,
              "RNG state after the profiled epoch equal to before")
        rate = EdgeRateCounter(trainer.edges_per_step,
                               trainer.step_timer.windowed(steps))
        out["edges_per_sec"] = rate.edges_per_sec
        check(rate.edges_per_sec > 0, "a positive edge rate")
        log(f"profiled epoch ({out['card']}): {out['profiled_epoch_s']:.1f}"
            f" s, trace {out['trace_mb']:.1f} MB, {out['cpu_op_events']} "
            f"CPU op events, {out['cuda_kernel_events']} CUDA kernel events"
            f" ({out['k1_kernel_events']} of them K1); "
            f"{rate.edges_per_sec / 1e9:.3f} Gedges/s; state and RNG "
            "restored bit for bit")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    drive(torch.device("cuda", 0))


def drive(device) -> None:
    """Every phase on `device` (the card; `main` requires one)."""
    t_start = time.perf_counter()
    import torch
    sys.path.insert(0, ROOT)
    from sagnn_tpu_torch.config import PRESETS
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.models.selfgnn import (SelfGNN, _interval_propagation,
                                                _temporal_fusion)
    from sagnn_tpu_torch.ops import _build
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.serve import Recommender

    # 1. device
    card = gpu_name_and_power()
    kind = torch.cuda.get_device_name(0)
    log(f"gpu: {card}")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, devices "
        f"{torch.cuda.device_count()}")

    # 2. build
    info = _build.build()
    log(f"build: {info.seconds:.2f} s -> {os.path.relpath(info.path, ROOT)}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")
    _build.load_library()

    # 3. set-up (host)
    base = PRESETS["gowalla"]
    cfg = base.replace(
        model=dataclasses.replace(base.model, spmm_backend="pallas"),
        train=dataclasses.replace(base.train, seed=PARAM_SEED))
    mc = cfg.model
    check((mc.latdim, mc.num_heads, mc.graph_num, mc.gnn_layer,
           mc.att_layer, mc.pos_length, cfg.train.test_size)
          == (64, 16, 3, 2, 1, 200, 1000), "gowalla preset widths")
    t0 = time.perf_counter()
    bundle = synthetic_dataset(num_users=NUM_USERS, num_items=NUM_ITEMS,
                               graph_num=mc.graph_num,
                               test_size=cfg.train.test_size,
                               seed=DATA_SEED, seq_len_range=SEQ_LEN_RANGE)
    t_bundle = time.perf_counter() - t0
    rec = Recommender(cfg, bundle, device=device)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    edges = [m.nnz for m in bundle.sub_mats]
    log(f"set-up: bundle {t_bundle:.1f} s, total {t_setup:.1f} s; "
        f"{NUM_USERS} users x {NUM_ITEMS} items, interval edges {edges}")

    phase_s = {"build": info.seconds, "set-up": t_setup}

    # 4. kernels against their plain versions, forward and backward
    t0 = time.perf_counter()
    records = kernel_phase(rec.graphs, device)
    records.update(backward_phase(rec.graphs, device))
    phase_s["kernels"] = time.perf_counter() - t0
    log(f"phase kernels: {phase_s['kernels']:.1f} s")

    # 5. serving: encode through the kernel, counts read just after
    t0 = time.perf_counter()
    sc.reset_launches()
    fu, fi = rec.encode()
    torch.cuda.synchronize()
    launches_exact = dict(sc.LAUNCHES)
    hops = mc.graph_num * mc.gnn_layer * 2
    log(f"encode launches: {launches_exact}")
    expect_launches(launches_exact, "encode", segsum_f32=hops)
    check(fu.shape == (NUM_USERS, 64) and fi.shape == (NUM_ITEMS, 64),
          "encoding shapes")
    # the reference: the plain ("xla") backend's propagation summed in f64,
    # then the same fusion stack in f32. The check then measures the
    # kernel's own rounding; the f32 plain backend's rounding (index_add_
    # atomics, in no fixed order) is logged beside it, not checked.
    plain_cfg = dataclasses.replace(mc, spmm_backend="xla")
    plain = SelfGNN(plain_cfg, NUM_USERS, NUM_ITEMS)
    p64 = dict(rec.params)
    for key in ("reg/u_embed", "reg/i_embed"):
        p64[key] = p64[key].double()
    uv64, iv64 = _interval_propagation(p64, rec.graphs, plain_cfg,
                                       NUM_USERS, NUM_ITEMS)
    uv, iv = _interval_propagation(rec.params, rec.graphs, mc, NUM_USERS,
                                   NUM_ITEMS)
    ru, ri = _temporal_fusion(rec.params, uv64.float(), iv64.float(), mc)
    pu, pi, _, _ = plain.encode(rec.params, rec.graphs)
    torch.cuda.synchronize()
    check_close(uv, uv64, 1e-5, 1e-5, "user_vec kernel vs plain f64")
    check_close(iv, iv64, 1e-5, 1e-5, "item_vec kernel vs plain f64")
    err_u = check_close(fu, ru, 1e-4, 1e-5, "final_user kernel vs plain")
    err_i = check_close(fi, ri, 1e-4, 1e-5, "final_item kernel vs plain")
    log(f"encode kernel vs plain backend: max abs err user {err_u:.3e}, "
        f"item {err_i:.3e}; f32 plain backend vs the same reference: user "
        f"{max_err(pu, ru):.3e}, item {max_err(pi, ri):.3e}")
    encode_ms = cuda_ms(rec.encode, iters=5, warmup=1)
    # the last of those encodes against the first: the kernel path has no
    # atomics, so any difference is logged (not checked) as a finding
    fu_last, fi_last = rec.encodings
    encode_repeat_diff = max(max_err(fu_last, fu), max_err(fi_last, fi))
    log(f"encode repeated 6 times: max abs diff from the first "
        f"{encode_repeat_diff:.3e}")
    # breakdown: the 12 propagation hops (kernel + leaky-relu + residual
    # adds) alone; the rest of the encode is the fusion stack
    propagation_ms = cuda_ms(
        lambda: _interval_propagation(rec.params, rec.graphs, mc, NUM_USERS,
                                      NUM_ITEMS), iters=5, warmup=1)
    log(f"encode {encode_ms:.3f} ms: propagation {propagation_ms:.3f} ms, "
        f"fusion {encode_ms - propagation_ms:.3f} ms")
    plain_encode_ms = cuda_ms(
        lambda: plain.encode(rec.params, rec.graphs), iters=5, warmup=1)

    users = bundle.tst_usrs[:SERVE_USERS]
    scores, items = rec.recommend(users, k=10, exclude_seen=True)
    torch.cuda.synchronize()
    check(scores.shape == items.shape == (len(users), 10), "top-k shape")
    check(bool(torch.isfinite(scores).all()), "top-k scores finite")
    check(bool((scores[:, :-1] >= scores[:, 1:]).all()), "top-k order")
    items_np = items.cpu().numpy()
    for b, u in enumerate(users):
        seen = set(bundle.sequences[u][-mc.pos_length:])
        check(not seen & set(items_np[b].tolist()), "seen item served")
    recommend_ms = cuda_ms(
        lambda: rec.recommend(users, k=10, exclude_seen=True), iters=10,
        warmup=2)

    metrics = rec.evaluate(max_users=EVAL_USERS)
    evaluate_s = cuda_ms(lambda: rec.evaluate(max_users=EVAL_USERS),
                         iters=1, warmup=1) / 1e3
    for k, v in metrics.items():
        check(math.isfinite(v) and 0.0 <= v <= 1.0, f"metric {k}={v}")
    log(f"evaluate over {min(EVAL_USERS, len(bundle.tst_usrs))} users: "
        f"HR@10 {metrics['HR@10']:.4f} NDCG@10 {metrics['NDCG@10']:.4f} "
        f"(random weights; 10/1000 = 0.01 is chance)")

    # second path: the same encode with the bf16 table
    rec_bf16 = Recommender(
        cfg.replace(model=dataclasses.replace(mc, spmm_exact=False)),
        bundle, rec.params, device=device)
    sc.reset_launches()
    fu16, fi16 = rec_bf16.encode()
    torch.cuda.synchronize()
    launches_bf16 = dict(sc.LAUNCHES)
    log(f"bf16 encode launches: {launches_bf16}")
    expect_launches(launches_bf16, "bf16 encode", segsum_bf16=hops)
    # the reference: the plain version on the bf16-rounded hop inputs,
    # summed in f64, then the same fusion stack in f32
    uv16, iv16 = _interval_propagation(rec_bf16.params, rec_bf16.graphs,
                                       rec_bf16.model.cfg, NUM_USERS,
                                       NUM_ITEMS)
    uv16_ref, iv16_ref = bf16_propagation_reference(
        rec_bf16.params, rec_bf16.graphs, rec_bf16.model.cfg, NUM_USERS,
        NUM_ITEMS)
    ru16, ri16 = _temporal_fusion(rec_bf16.params, uv16_ref.float(),
                                  iv16_ref.float(), mc)
    torch.cuda.synchronize()
    check_close(uv16, uv16_ref, 1e-5, 1e-5, "bf16 user_vec kernel vs plain")
    check_close(iv16, iv16_ref, 1e-5, 1e-5, "bf16 item_vec kernel vs plain")
    err16_u = check_close(fu16, ru16, 1e-4, 1e-5,
                          "bf16 final_user kernel vs plain")
    err16_i = check_close(fi16, ri16, 1e-4, 1e-5,
                          "bf16 final_item kernel vs plain")
    bf16_dev = max(max_err(fu16, fu), max_err(fi16, fi))
    bf16_encode_ms = cuda_ms(rec_bf16.encode, iters=5, warmup=1)
    log(f"bf16 encode kernel vs plain: max abs err user {err16_u:.3e}, "
        f"item {err16_i:.3e}; max abs deviation from the exact encode "
        f"{bf16_dev:.3e}")

    # K4 on the gowalla path: the encode with spmm_fold_gather on both
    # table types; the fold reads the same rows in the same order, so the
    # node states are K1's bit for bit
    fold_launches, fold_encode_ms = {}, {}
    for exact, states, mode in ((True, (uv, iv), "f32"),
                                (False, (uv16, iv16), "bf16")):
        fold_model = SelfGNN(dataclasses.replace(
            mc, spmm_exact=exact, spmm_fold_gather=True), NUM_USERS,
            NUM_ITEMS)
        sc.reset_launches()
        _, _, fuv, fiv = fold_model.encode(rec.params, rec.graphs)
        torch.cuda.synchronize()
        fold_launches[mode] = dict(sc.LAUNCHES)
        log(f"{mode} fold encode launches: {fold_launches[mode]}")
        expect_launches(fold_launches[mode], f"{mode} fold encode",
                        **{f"segsum_fold_{mode}": hops})
        check(torch.equal(fuv, states[0]) and torch.equal(fiv, states[1]),
              f"{mode} fold encode: the unfolded node states bit for bit")
        fold_encode_ms[mode] = cuda_ms(
            lambda: fold_model.encode(rec.params, rec.graphs), iters=5,
            warmup=1)
    log(f"fold encode f32 {fold_encode_ms['f32']:.3f} ms, bf16 "
        f"{fold_encode_ms['bf16']:.3f} ms")

    phase_s["serving"] = time.perf_counter() - t0
    log(f"phase serving: {phase_s['serving']:.1f} s")

    # 8. serving the edge variants (weighted K2, attention K5 + K2)
    t0 = time.perf_counter()
    variants, vlaunches, vrecs = variant_serving_phase(cfg, bundle,
                                                       rec.params, device)
    phase_s["variant serving"] = time.perf_counter() - t0
    log(f"phase variant serving: {phase_s['variant serving']:.1f} s")

    # 9. K2 and K5 against their plain versions, forward and backward, on
    # the "mean" variant's graphs (its weights, both permutations)
    t0 = time.perf_counter()
    records.update(edge_kernel_phase(vrecs["mean"].graphs, device))
    records.update(edge_backward_phase(vrecs["mean"].graphs, device))
    p1_kernels = p1_kernels_per_call(device)
    phase_s["edge kernels"] = time.perf_counter() - t0
    log(f"phase edge kernels: {phase_s['edge kernels']:.1f} s")

    # 6. one training step, kernel path against the plain path
    t0 = time.perf_counter()
    step, batch = train_step_phase(cfg, bundle, rec.params, rec.graphs,
                                   device)
    phase_s["train step check"] = time.perf_counter() - t0
    log(f"phase train step check: {phase_s['train step check']:.1f} s")

    # 10. the variants' training steps on the same batch
    t0 = time.perf_counter()
    vsteps = variant_step_phase(cfg, bundle, rec.params, batch, vrecs,
                                device)
    phase_s["variant steps"] = time.perf_counter() - t0
    log(f"phase variant steps: {phase_s['variant steps']:.1f} s")

    # 15. the --bf16 throughput mode at gowalla width
    t0 = time.perf_counter()
    bf16_mode = bf16_mode_phase(cfg, bundle, rec.params, (fu, fi), batch,
                                device)
    phase_s["bf16 mode"] = time.perf_counter() - t0
    log(f"phase bf16 mode: {phase_s['bf16 mode']:.1f} s")

    # 16. per-token sequence attention at gowalla width, f32 and bf16
    t0 = time.perf_counter()
    per_token = per_token_phase(cfg, bundle, rec.params, rec.graphs, batch,
                                device)
    phase_s["per-token attention"] = time.perf_counter() - t0
    log(f"phase per-token attention: "
        f"{phase_s['per-token attention']:.1f} s")

    # 18. the TF1 reference's weights imported, served and trained on
    t0 = time.perf_counter()
    tf1 = tf1_import_phase(device)
    phase_s["tf1 import"] = time.perf_counter() - t0
    log(f"phase tf1 import: {phase_s['tf1 import']:.1f} s")

    # 7. training through the Trainer: one epoch, evaluation, checkpoint,
    # resume
    t0 = time.perf_counter()
    training = training_phase(cfg, bundle, device)
    phase_s["training"] = time.perf_counter() - t0
    log(f"phase training: {phase_s['training']:.1f} s")

    # 11. the variants through the Trainer
    t0 = time.perf_counter()
    vtraining = variant_training_phase(cfg, bundle, device)
    phase_s["variant training"] = time.perf_counter() - t0
    log(f"phase variant training: {phase_s['variant training']:.1f} s")

    # 19. the user path: a raw log preprocessed, trained under the wedge
    # watchdog through an induced wedge, its checkpoint served
    t0 = time.perf_counter()
    user_path = user_path_phase(device)
    phase_s["user path"] = time.perf_counter() - t0
    log(f"phase user path: {phase_s['user path']:.1f} s")

    # 21. the profiler trace of one epoch, state and RNG restored
    t0 = time.perf_counter()
    profiler_trace = profiler_trace_phase(cfg, bundle, device)
    phase_s["profiler trace"] = time.perf_counter() - t0
    log(f"phase profiler trace: {phase_s['profiler trace']:.1f} s")

    # 13. the ring backend (K6) on a one-card mesh of four ranks
    t0 = time.perf_counter()
    ring, rrecords = ring_phase(cfg, bundle, rec.params, batch, rec, vrecs,
                                device)
    records.update(rrecords)
    phase_s["ring"] = time.perf_counter() - t0
    log(f"phase ring: {phase_s['ring']:.1f} s")

    # 12. the 1M-user flagship: K3 and K4 through the Trainer and the
    # Recommender
    t0 = time.perf_counter()
    flagship, frecords, flagship_hops, flagship_bundle = flagship_phase(
        device)
    records.update(frecords)
    phase_s["flagship"] = time.perf_counter() - t0
    log(f"phase flagship: {phase_s['flagship']:.1f} s")

    # 17. the flagship's bf16_b4096 recipe on the same bundle
    t0 = time.perf_counter()
    bf16_b4096, flagship_catalog = flagship_bf16_phase(flagship_bundle,
                                                       device)
    del flagship_bundle
    phase_s["flagship bf16_b4096"] = time.perf_counter() - t0
    log(f"phase flagship bf16_b4096: {phase_s['flagship bf16_b4096']:.1f} s")

    # 20. catalog-sharded top-k on the gowalla and the flagship catalogs
    t0 = time.perf_counter()
    from sagnn_tpu_torch.data.sampler import user_sequences
    s_seq, s_mask = (torch.from_numpy(a).to(device) for a in
                     user_sequences(bundle, users, mc.pos_length))
    s_fu, s_fi = rec.encodings
    s_q = rec.model.serving_queries(rec.params, s_fu, s_fi,
                                    torch.from_numpy(users).to(device),
                                    s_seq, s_mask)
    sharded = sharded_serving_phase(
        (("gowalla", (s_q, s_fi, s_seq, s_mask), (-1, SHARDED_CHUNK_ROWS)),
         ("flagship", flagship_catalog, (0,))), device)
    del flagship_catalog, s_q
    phase_s["sharded serving"] = time.perf_counter() - t0
    log(f"phase sharded serving: {phase_s['sharded serving']:.1f} s")

    # 14. the probes: P1 and P2 against their plain versions, then the
    # probe CLI's measurements on both bundles' interval 0
    t0 = time.perf_counter()
    probe_results, precords = probes_phase(rec.graphs, flagship_hops,
                                           p1_kernels, device)
    records.update(precords)
    del flagship_hops
    phase_s["probes"] = time.perf_counter() - t0
    log(f"phase probes: {phase_s['probes']:.1f} s")

    # `launches`: the count on the path each kernel belongs to, read just
    # after it (the serving encode for the forward kernels, the training
    # run for the f32 backward, the bf16-table train step for the bf16
    # backward); the other paths' counts beside it
    steps = training["steps"]
    run = training["launches_run"]
    records["segsum_f32"].update(
        launches=launches_exact["segsum_f32"],
        launches_per_encode=launches_exact["segsum_f32"],
        launches_per_train_step=step["launches_per_step"]["segsum_f32"],
        launches_training_run=run["segsum_f32"])
    records["segsum_bf16"].update(
        launches=launches_bf16["segsum_bf16"],
        launches_per_encode=launches_bf16["segsum_bf16"],
        launches_per_train_step=step["launches_per_bf16_step"]["segsum_bf16"])
    records["segsum_f32_bwd"].update(
        launches=run["segsum_f32_bwd"],
        launches_per_train_step=step["launches_per_step"]["segsum_f32_bwd"],
        launches_training_run=run["segsum_f32_bwd"])
    records["segsum_bf16_bwd"].update(
        launches=step["launches_per_bf16_step"]["segsum_bf16_bwd"],
        launches_per_train_step=step["launches_per_bf16_step"][
            "segsum_bf16_bwd"])
    # K2 and K5: the serving encodes for the forward kernels (sym_sqrt for
    # K2, attention for K5, the bf16 attention encode for the bf16 modes),
    # the attention training run for the f32 backwards, the bf16 attention
    # step for the bf16 backwards
    att_run = vtraining["attention"]["launches_run"]
    per_step = {k: v["launches_per_step"] for k, v in vsteps.items()}

    def step_counts(name):
        return {k: v[name] for k, v in per_step.items() if name in v}

    for name, launches, per_encode in (
            ("wsegsum_f32", vlaunches["sym_sqrt"]["wsegsum_f32"],
             {v: vlaunches[v]["wsegsum_f32"]
              for v in ("sym_sqrt", "mean", "attention")}),
            ("wsegsum_bf16", vlaunches["attention_bf16"]["wsegsum_bf16"],
             {"attention_bf16": vlaunches["attention_bf16"]["wsegsum_bf16"]}),
            ("sddmm_f32", vlaunches["attention"]["sddmm_f32"],
             {"attention": vlaunches["attention"]["sddmm_f32"]}),
            ("sddmm_bf16", vlaunches["attention_bf16"]["sddmm_bf16"],
             {"attention_bf16": vlaunches["attention_bf16"]["sddmm_bf16"]}),
            ("wsegsum_f32_bwd", att_run["wsegsum_f32_bwd"], None),
            ("sddmm_f32_bwd", att_run["sddmm_f32_bwd"], None),
            ("wsegsum_bf16_bwd",
             per_step["attention_bf16"]["wsegsum_bf16_bwd"], None),
            ("sddmm_bf16_bwd",
             per_step["attention_bf16"]["sddmm_bf16_bwd"], None)):
        records[name].update(launches=launches,
                             launches_per_train_step=step_counts(name))
        if per_encode is not None:
            records[name]["launches_per_encode"] = per_encode
        if name in att_run:
            records[name]["launches_attention_training_run"] = att_run[name]
    # K3 and K4: the flagship's Recommender encode (K3), its bf16 encode,
    # the gowalla fold encodes and fold steps (K4), the flagship Trainer
    # steps (K3 with K4, f32) and its fold-off and bf16 steps
    fl = flagship["launches"]
    fold_steps = step["launches_per_fold_step"]
    for name, count, path in (
            ("segsum_acc_f32", fl["encode"], "flagship Recommender encode"),
            ("segsum_acc_bf16", fl["bf16_encode"], "flagship bf16 encode"),
            ("segsum_fold_f32", fold_launches["f32"], "gowalla fold encode"),
            ("segsum_fold_bf16", fold_launches["bf16"],
             "gowalla bf16 fold encode"),
            ("segsum_fold_acc_f32", fl["trainer_steps"],
             f"flagship Trainer, {FLAGSHIP_STEPS + 1} steps"),
            ("segsum_fold_acc_f32_bwd", fl["trainer_steps"],
             f"flagship Trainer, {FLAGSHIP_STEPS + 1} steps"),
            ("segsum_fold_acc_bf16", fl["step_bf16"], "flagship bf16 step"),
            ("segsum_fold_acc_bf16_bwd", fl["step_bf16"],
             "flagship bf16 step"),
            ("segsum_acc_f32_bwd", fl["step_fold_off"],
             "flagship step, fold off"),
            ("segsum_acc_bf16_bwd", fl["step_bf16_fold_off"],
             "flagship bf16 step, fold off"),
            ("segsum_fold_f32_bwd", fold_steps["f32"], "gowalla fold step"),
            ("segsum_fold_bf16_bwd", fold_steps["bf16"],
             "gowalla bf16 fold step")):
        records[name].update(launches=count.get(name, 0), launches_path=path)
    # K6: the ring encode (unweighted), the sym_sqrt ring encode and step
    # (weighted), the ring Trainer run (the unweighted backward)
    rl = ring["launches"]
    for name, count, path, step_path in (
            ("ring_segsum_f32", rl["encode"], "ring encode", "step"),
            ("ring_segsum_f32_bwd", rl["trainer_run"],
             f"ring Trainer run, {ring['steps']} steps", "step"),
            ("ring_wsegsum_f32", rl["sym_sqrt_encode"],
             "ring sym_sqrt encode", "sym_sqrt_step"),
            ("ring_wsegsum_f32_bwd", rl["sym_sqrt_step"],
             "ring sym_sqrt step", "sym_sqrt_step")):
        records[name].update(
            launches=count.get(name, 0), launches_path=path,
            launches_per_train_step=rl[step_path].get(name, 0))
    # this slice's paths, each counted from 0 just before it: the --bf16
    # model (K1 bf16) and the bf16_b4096 recipe (K3 bf16, no fold)
    records["segsum_bf16"].update(
        launches_bf16_mode_encode=bf16_mode["launches_encode"]["segsum_bf16"],
        launches_bf16_mode_step=bf16_mode["launches_step"]["segsum_bf16"])
    records["segsum_bf16_bwd"].update(
        launches_bf16_mode_step=bf16_mode["launches_step"][
            "segsum_bf16_bwd"])
    for name in ("segsum_acc_bf16", "segsum_acc_bf16_bwd"):
        records[name].update(
            launches_bf16_b4096_steps=bf16_b4096["launches_steps"][name],
            launches_bf16_b4096_encode=bf16_b4096["launches_encode"].get(
                name, 0))
    # phases 19 and 21, each counted from 0 just before it: the served
    # checkpoint's encode and the profiled epoch
    records["segsum_f32"].update(
        launches_user_path_encode=user_path["launches_encode"].get(
            "segsum_f32", 0),
        launches_profiled_epoch=profiler_trace["launches"].get(
            "segsum_f32", 0))
    records["segsum_f32_bwd"].update(
        launches_profiled_epoch=profiler_trace["launches"].get(
            "segsum_f32_bwd", 0))
    schedule_report(records)
    kernels = []
    for r in records.values():
        r["kernel_ms"] = r["ms"]
        r["ok"] = True
        r["timed"] = r.get("timed") or (
            "ms/plain_ms/library_ms/bound_ms: one user-target plus one "
            "item-target hop on interval 0 of the "
            + ("flagship bundle (1,048,576 x 786,432, ~21.4M edges per "
               "interval; k1_ms: K1 on the same hops)"
               if r["name"].startswith(("segsum_acc", "segsum_fold"))
               else "gowalla-scale bundle"
               + (f" over a one-card mesh of {RING_MODEL} ranks (k12_ms: "
                  "K1/K2 on the same hops, unsharded)"
                  if r["name"].startswith("ring") else ""))
            + " (the backward: K1 to K4 the dx of each, K5 the dw); each "
            "time is the device time per call (CUDA events, the host's "
            "cost of the calls taken out: profiling.device_ms)")
        check(r["launches"] > 0, f"{r['name']}: launched on its path")
        kernels.append(r)
    main_path = {
        "card": card, "setup_s": t_setup, "bundle_s": t_bundle,
        "build_s": info.seconds, "encode_ms": encode_ms,
        "encode_repeat_max_diff": encode_repeat_diff,
        "propagation_ms": propagation_ms,
        "plain_encode_ms": plain_encode_ms, "bf16_encode_ms": bf16_encode_ms,
        "recommend_ms": recommend_ms, "recommend_users": len(users),
        "evaluate_s": evaluate_s, "evaluate_users": min(
            EVAL_USERS, len(bundle.tst_usrs)), "metrics": metrics,
        "interval_edges": edges, "variants": variants,
        "fold_encode_ms": fold_encode_ms,
        "ring": ring,
        "flagship": {k: v for k, v in flagship.items()
                     if k not in ("launches", "trainer_losses")},
        "flagship_launches": flagship["launches"],
        "full_sort": {"gowalla": {
            "s": training["full_sort_s"], "users": training["evaluate_users"],
            "items": NUM_ITEMS, "mode": "dense"},
            "flagship": {"s": flagship["full_sort_s"],
                         "users": flagship["full_sort_users"],
                         "items": FLAGSHIP["num_items"], "mode": "streamed",
                         "tie_check": flagship["full_sort_ties"]}},
        "sampler": {"host_ms_per_batch": training[
            "host_sample_ms_by_backend"], "epoch_s": {
            "native": training["epoch_s"],
            "numpy": training["epoch_s_numpy"]}},
        "probes": probe_results, "bf16_mode": bf16_mode,
        "per_token": per_token,
        "bf16_b4096": {k: v for k, v in bf16_b4096.items()
                       if k != "trainer_losses"},
        "tf1_import": tf1, "user_path": user_path,
        "sharded_serving": sharded, "profiler_trace": profiler_trace}
    log("main_path " + json.dumps(main_path))
    train = {"card": card, "steps_per_epoch": steps,
             **{k: v for k, v in training.items()
                if k not in ("steps", "launches_run")},
             "launches_training_run": {k: v for k, v in run.items() if v},
             "step_check": step, "variant_steps": vsteps,
             "variant_training": vtraining, "phase_s": phase_s,
             "total_s": time.perf_counter() - t_start}
    log(json.dumps({"train": train}))
    log(card)   # nvidia-smi's name,power.limit line
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
