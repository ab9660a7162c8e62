"""The SDDMM kernel's (K5) and the row-gather probe's (P1) schedules on the
host (CPU only): the lane layout, grid and scratch that
`spmm_cuda.sddmm_schedule` and `probes.gather_schedule` give, held against
numpy models of what `csrc/sddmm.cu` and `csrc/probes.cu` do with them, on
the worst plans of those sizes.

The K5 model follows the kernel: the spans of SDDMM_SPAN slots walked by
lane groups with the grid's stride, the passes over the columns, the
batches of SDDMM_BATCH edges, and the load of a target row only where a
run of equal targets starts in a span. It checks that every span is
walked once, every slot scored once (pad slots 0), every column covered
once, no id, x row or y row read outside the plan and tables, y loaded
once per (span, run), and the scores equal `sddmm_apply_plain`. The P1
model follows its chunks, warps' shares and lane groups, and sums the
chunk partials in chunk order.
"""

import numpy as np
import pytest
import torch

from sagnn_tpu_torch.ops import probes
from sagnn_tpu_torch.ops import spmm_cuda as sc

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

SPAN, BATCH = sc.SDDMM_SPAN, sc.SDDMM_BATCH
WARPS = sc.SDDMM_WARPS_PER_BLOCK
DS = [2, 16, 64, 96, 130]


def _sddmm_model(x, y, src, tgt, ptr, sched):
    """K5's launch of `sched` in numpy (f64): (scores, what it touched)."""
    num_slots, num_tgt, d = len(src), len(ptr) - 1, x.shape[1]
    n_edges = int(ptr[-1])
    groups = 32 // sched.lanes
    spans = -(-num_slots // SPAN)
    assert spans == sched.spans
    out = np.full(num_slots, np.nan)
    writes = np.zeros(num_slots, np.int64)
    visits = np.zeros(spans, np.int64)
    y_loads = {}                      # (span, pass) -> target rows loaded
    stride = sched.blocks * WARPS * groups
    for first in range(sched.blocks * WARPS * groups):
        for span in range(first, spans, stride):
            visits[span] += 1
            beg, end = span * SPAN, min(num_slots, span * SPAN + SPAN)
            live_end = max(beg, min(end, n_edges))
            covered = np.zeros(d, np.int64)
            for c in range(sched.chunks):
                lo = c * sched.lanes * sched.vec
                cols = np.arange(lo, min(d, lo + sched.lanes * sched.vec))
                covered[cols] += 1
                cur_t, ycur = -1, np.zeros(len(cols))
                loads = y_loads.setdefault((span, c), [])
                for b in range(beg, end, BATCH):
                    for e in range(b, min(b + BATCH, end)):
                        if e >= live_end:          # a pad slot
                            part = 0.0
                        else:
                            assert 0 <= e < n_edges <= len(tgt)
                            s, t = int(src[e]), int(tgt[e])
                            assert 0 <= s < x.shape[0]
                            if t != cur_t:         # a run starts: load y[t]
                                assert 0 <= t < num_tgt
                                loads.append(t)
                                cur_t, ycur = t, y[t, cols]
                            part = float(x[s, cols] @ ycur)
                        if c == 0:
                            out[e] = part
                            writes[e] += 1
                        else:
                            out[e] += part
            assert (covered == 1).all(), "every column in one pass"
    return out, writes, visits, y_loads


def _runs(tgt, n_edges, span):
    """The runs of equal targets among the real edges of one span."""
    beg, end = span * SPAN, min(n_edges, span * SPAN + SPAN)
    if beg >= end:
        return 0
    t = np.asarray(tgt[beg:end])
    return 1 + int((t[1:] != t[:-1]).sum())


def _plan(kind, seed=0):
    """(src, tgt, ptr, n_src) of a worst plan, target-sorted, pad slots
    (tgt = num_tgt) after the real edges: "one_target" (every edge onto
    one target, across many spans), "distinct" (every edge its own
    target), "crossing" (runs of 100 edges that cross span boundaries at
    every offset), "random", "empty" (all pad)."""
    rng = np.random.default_rng(seed)
    n_src, pad = 300, 37
    if kind == "one_target":
        num_tgt, tgt = 50, np.full(1500, 17)
    elif kind == "distinct":
        num_tgt = 1200
        tgt = np.arange(num_tgt)
    elif kind == "crossing":
        num_tgt = 40
        tgt = np.repeat(np.arange(0, num_tgt, 2), 100)[:1999]
    elif kind == "random":
        num_tgt = 400
        tgt = np.sort(rng.integers(0, num_tgt, 3000))
    else:
        num_tgt, tgt = 64, np.zeros(0, np.int64)
    tgt = np.concatenate([tgt, np.full(pad, num_tgt)]).astype(np.int32)
    src = rng.integers(0, n_src, len(tgt)).astype(np.int32)
    ptr = sc.csr_row_ptr(tgt, num_tgt)
    return src, tgt, ptr, n_src


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("kind", ["one_target", "distinct", "crossing",
                                  "random", "empty"])
def test_sddmm_schedule_covers_the_worst_plans(kind, d, exact):
    """On a one-SM grid and a full card's, every span walked once and every
    slot scored once with the plain version's score (pad slots 0; bf16
    mode: the values rounded to bf16 as the kernel reads them); no read
    outside the ids, x or y; y loaded once per (span, run) in each pass,
    as `sddmm_row_loads` counts."""
    src, tgt, ptr, n_src = _plan(kind)
    rng = np.random.default_rng(d)
    # f32 values (the kernel's tables), held in f64
    x = rng.standard_normal((n_src, d)).astype(np.float32).astype(np.float64)
    y = rng.standard_normal((len(ptr) - 1, d)).astype(np.float32).astype(
        np.float64)
    n_edges = int(ptr[-1])

    def read(t):   # a table's values as the kernel multiplies them
        if exact:
            return t
        return torch.from_numpy(t).float().to(torch.bfloat16).double().numpy()

    want = sc.sddmm_apply_plain(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(src),
        torch.from_numpy(tgt), torch.from_numpy(ptr), exact).numpy()
    for sm_count in (1, 132):
        sched = sc.sddmm_schedule(len(src), d, sm_count)
        out, writes, visits, y_loads = _sddmm_model(read(x), read(y), src,
                                                    tgt, ptr, sched)
        assert (visits == 1).all()
        assert (writes == 1).all()
        np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)
        assert not out[n_edges:].any()
        for (span, _), loads in y_loads.items():
            assert len(loads) == _runs(tgt, n_edges, span)
        per_pass = sum(len(v) for (_, c), v in y_loads.items() if c == 0)
        assert per_pass == sc.sddmm_row_loads(torch.from_numpy(tgt), n_edges)
        if kind == "one_target":
            # one load of the row per span it reaches, no more
            assert per_pass == -(-n_edges // SPAN)
        if kind == "distinct":
            assert per_pass == n_edges


# d = 2: one lane of 2 values; 6: 2-value lanes, 3 of a group of 4 live;
# 64: 16 lanes of float4; 130: 2-value lanes, 3 passes; 256: 2 passes
@pytest.mark.parametrize("num_slots", [0, SPAN + 1, 2 ** 31 - 1])
@pytest.mark.parametrize("d", [2, 6, 64, 130, 256])
def test_sddmm_schedule_sizes(num_slots, d):
    """A lane holds at most 16 bytes of an f32 row, vec values that divide
    d; the lanes are a power of two up to 32 and the passes cover d with
    less than one pass to spare; the grid is at least one block and at
    most SDDMM_BLOCKS_PER_SM per SM, never more warps than the spans
    need."""
    for sm_count in (1, 132):
        s = sc.sddmm_schedule(num_slots, d, sm_count)
        assert s.vec * 4 <= sc.LANE_BYTES and d % s.vec == 0
        assert s.vec == max(v for v in (2, 4) if d % v == 0)
        assert s.lanes & (s.lanes - 1) == 0 and 1 <= s.lanes <= 32
        assert s.rows_per_instruction * s.lanes == 32
        assert (s.chunks - 1) * s.lanes * s.vec < d \
            <= s.chunks * s.lanes * s.vec
        if s.chunks == 1:
            assert s.lanes // 2 * s.vec < d  # no narrower group would do
        assert s.spans == -(-num_slots // sc.SDDMM_SPAN)
        assert 1 <= s.blocks <= sm_count * sc.SDDMM_BLOCKS_PER_SM
        assert (s.blocks - 1) * WARPS * s.rows_per_instruction \
            < max(1, s.spans)


def test_sddmm_lanes_at_the_main_paths_width():
    """D = 64: 16 lanes of float4, 2 rows per warp load, in both modes
    (bf16 mode reads the f32 tables and rounds them in registers); a
    gowalla hop's 492,965 slots fill 482 blocks."""
    s = sc.sddmm_schedule(492_965, 64, 132)
    assert (s.vec, s.lanes, s.rows_per_instruction, s.chunks) == (4, 16, 2, 1)
    assert s.blocks == 482


def test_sddmm_row_loads_counts_runs_per_span():
    t = torch.tensor([0] * 70 + [1] * 3 + [5] * 100 + [9] * 7,
                     dtype=torch.int32)   # the last 7 slots are pad
    # spans [0, 64): 1 run; [64, 128): 0, 1, 5; [128, 173): 5
    assert sc.sddmm_row_loads(t, 173) == 5
    assert sc.sddmm_row_loads(t, 0) == 0


# -- P1 ---------------------------------------------------------------------

CHUNK, P1_WARPS = probes.P1_CHUNK_ROWS, probes.P1_WARPS_PER_BLOCK


def _gather_model(x, src, run, in_flight, sched):
    """P1's launch of `sched` in numpy (f64): (out, rows read per id row,
    chunks written)."""
    n_ids, d = len(src), x.shape[1]
    rows = n_ids * run
    groups = sched.rows_per_instruction
    reads = np.zeros(rows, np.int64)
    partial = np.full((max(1, sched.chunks), d), np.nan)
    written = np.zeros(max(1, sched.chunks), np.int64)
    warp_rows = CHUNK // P1_WARPS
    for block in range(sched.blocks):
        for c in range(block, sched.chunks, sched.blocks):
            assert (c + 1) * d <= sched.scratch_floats
            sums = []
            for w in range(P1_WARPS):
                r0 = c * CHUNK + w * warp_rows
                r1 = min(rows, r0 + warp_rows)
                acc = np.zeros(d)
                for base in range(r0, r1, in_flight * groups):
                    for u in range(in_flight):
                        for g in range(groups):
                            row = base + u * groups + g
                            if row < r1:
                                reads[row] += 1
                                assert row // run < n_ids
                                rid = int(src[row // run]) + row % run
                                assert 0 <= rid < x.shape[0]
                                acc += x[rid]
                sums.append(acc)
            partial[c] = np.sum(sums, axis=0)
            written[c] += 1
    out = partial[:sched.chunks].sum(0) if sched.chunks else np.zeros(d)
    return out, reads, written[:sched.chunks]


# the extremes of run and loads in flight (the tails of a warp's share);
# n_ids 0 and 1; narrow lanes (d = 2, 6), wide ones (48, 64), bf16 rows
@pytest.mark.parametrize("run", [1, 16])
@pytest.mark.parametrize("in_flight", [1, 8])
@pytest.mark.parametrize("n_ids,d,x_bytes", [
    (0, 64, 4), (1, 2, 4), (1500, 64, 4), (1500, 64, 2), (1033, 48, 4),
    (777, 6, 2)])
def test_gather_schedule_reads_every_row_once(n_ids, d, x_bytes, run,
                                              in_flight):
    """On a one-SM grid and a full card's, every row of every id read once,
    inside the table; every chunk's partial written once inside the
    scratch; their sum is the plain version's."""
    rng = np.random.default_rng(n_ids + run)
    n_rows = 3000
    src = probes.probe_ids(n_rows, n_ids * run, run, chunk=512)
    x = rng.standard_normal((n_rows, d))
    want = probes.gather_sum_plain(torch.from_numpy(x),
                                   torch.from_numpy(src), run).numpy()
    for sm_count in (1, 132):
        sched = probes.gather_schedule(len(src), run, d, sm_count, x_bytes)
        assert sched.chunks == -(-len(src) * run // CHUNK)
        out, reads, written = _gather_model(x, src, run, in_flight, sched)
        assert (reads == 1).all() and (written == 1).all()
        np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_ids", [0, 1, CHUNK, 2 ** 31 - 1])
def test_gather_schedule_sizes(n_ids):
    """At least one block (an empty call still writes its zeros), at most
    P1_BLOCKS_PER_SM per SM and one per chunk; a D-float partial per
    chunk; one pass of the lanes (D <= 64)."""
    for sm_count in (1, 132):
        for run in probes.RUNS:
            s = probes.gather_schedule(n_ids, run, 64, sm_count)
            assert s.chunks == -(-n_ids * run // CHUNK)
            assert 1 <= s.blocks <= max(
                1, min(s.chunks, sm_count * probes.P1_BLOCKS_PER_SM))
            assert s.scratch_floats == max(1, s.chunks * 64)
            assert (s.vec, s.lanes) == (4, 16)
    with pytest.raises(ValueError):
        probes.gather_schedule(10, 1, 96, 132)


def test_kernels_are_compiled_with_these_schedules():
    """The K5 and P1 schedules have one source each: `_build` compiles
    csrc/sddmm.cu and csrc/probes.cu with the host's constants as -D
    defines (hashed into the library's name), and the kernels take their
    constants from them."""
    import os
    import re

    from sagnn_tpu_torch.ops import _build

    flags = _build._flags()
    for macro, value in (
            ("SAGNN_SDDMM_SPAN", sc.SDDMM_SPAN),
            ("SAGNN_SDDMM_BATCH", sc.SDDMM_BATCH),
            ("SAGNN_SDDMM_WARPS_PER_BLOCK", sc.SDDMM_WARPS_PER_BLOCK),
            ("SAGNN_SDDMM_BLOCKS_PER_SM", sc.SDDMM_BLOCKS_PER_SM),
            ("SAGNN_P1_CHUNK_ROWS", probes.P1_CHUNK_ROWS),
            ("SAGNN_P1_WARPS_PER_BLOCK", probes.P1_WARPS_PER_BLOCK)):
        assert f"-D{macro}={value}" in flags
    for source, pairs in (
            ("sddmm.cu", (("kSpan", "SAGNN_SDDMM_SPAN"),
                          ("kBatch", "SAGNN_SDDMM_BATCH"),
                          ("kWarpsPerBlock", "SAGNN_SDDMM_WARPS_PER_BLOCK"),
                          ("kBlocksPerSm", "SAGNN_SDDMM_BLOCKS_PER_SM"))),
            ("probes.cu", (("kChunkRows", "SAGNN_P1_CHUNK_ROWS"),
                           ("kWarpsPerBlock", "SAGNN_P1_WARPS_PER_BLOCK")))):
        with open(os.path.join(_build.CSRC_DIR, source)) as f:
            text = f.read()
        for name, macro in pairs:
            assert re.search(rf"constexpr int {name} = {macro};", text), name
