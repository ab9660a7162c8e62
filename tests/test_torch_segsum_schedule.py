"""The segment-sum kernel's schedule on the host (CPU only): the grid and
scratch sizing that `spmm_cuda._launch_segsum` takes from
`segsum_schedule`, held against a model of what the kernel in
`csrc/segsum.cu` does with them, on the worst plans of those sizes.

The model follows the kernel step by step in numpy: the 16-ary merge-path
search of each piece's start and end, the head and tail parts of rows
split between pieces and their scratch slots, the arrival counters, and
the combine of a split row's parts in piece order by whichever piece
arrives last (the arrival order is shuffled). It checks that every piece,
counter and scratch slot the kernel touches lies inside the sizes
`segsum_schedule` gives for (num_tgt, len(src)), that every row is written
exactly once (K3: rows without edges never), and that the sums are the
plain version's.
"""

import numpy as np
import pytest

from sagnn_tpu_torch.ops import spmm_cuda as sc

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

M = sc.PIECE_ITEMS


def _rows_before(ptr, ptr0, num_tgt, num_edges, diag):
    """The kernel's `rows_before`: the 16-ary search, 15 probes per
    step, of #{t : t + 1 + (ptr[t+1] - ptr0) <= diag}."""
    lo, hi = max(0, diag - num_edges), min(diag, num_tgt)
    steps = 0
    while lo < hi:
        n = hi - lo
        qs = [lo + (n * (k + 1) >> 4) for k in range(15)]
        c = sum(int(ptr[q + 1]) - ptr0 + q + 1 <= diag for q in qs)
        new_lo = lo if c == 0 else lo + (n * c >> 4) + 1
        hi = hi if c == 15 else lo + (n * (c + 1) >> 4)
        lo = new_lo
        steps += 1
    return lo, steps


def _model(x, src, ptr, sched, accumulate=False, out=None, seed=0):
    """The kernel's result and what it touched, launch of `sched`: (out,
    writes per row, highest counter index, highest scratch float)."""
    num_tgt, d = len(ptr) - 1, x.shape[1]
    ptr0 = int(ptr[0])
    num_edges = int(ptr[-1]) - ptr0
    out = np.zeros((num_tgt, d)) if out is None else out.astype(np.float64)
    writes = np.zeros(num_tgt, np.int64)
    if accumulate and num_edges == 0:
        return out, writes, -1, -1
    items = num_tgt + num_edges
    pieces = -(-items // M)
    assert pieces <= sched.pieces
    scratch = np.full((sched.scratch_floats // d, d), np.nan)
    counters = np.zeros(sched.pieces, np.int64)
    top_counter = top_scratch = -1
    arrivals = []          # (counter, pieces to wait for, row, piece)

    def row_sum(lo, hi):
        return x[src[ptr0 + lo:ptr0 + hi]].sum(0)

    def write(row, value):
        writes[row] += 1
        out[row] = out[row] + value if accumulate else value

    for p in range(pieces):
        lo_item, hi_item = p * M, min(p * M + M, items)
        row0, _ = _rows_before(ptr, ptr0, num_tgt, num_edges, lo_item)
        row1, _ = _rows_before(ptr, ptr0, num_tgt, num_edges, hi_item)
        edge0, edge1 = lo_item - row0, hi_item - row1
        nr = row1 - row0
        assert 0 <= edge1 - edge0 <= M and 0 <= nr <= M
        np_ = min(nr + 2, num_tgt + 1 - row0)
        rp = [int(ptr[row0 + k]) - ptr0 for k in range(np_)]
        head = edge0 > rp[0]
        tail = row1 < num_tgt and edge1 > rp[nr] and (nr > 0 or not head)
        for k in range(nr):             # rows that end in this piece
            beg, end = max(rp[k], edge0), rp[k + 1]
            part = row_sum(beg, end)
            if k == 0 and head:
                scratch[2 * p] = part
                top_scratch = max(top_scratch, (2 * p + 1) * d - 1)
            elif not accumulate or rp[k + 1] > rp[k]:
                write(row0 + k, part)
        if tail or (head and nr == 0):
            beg = rp[nr] if tail else edge0
            scratch[2 * p + tail] = row_sum(beg, edge1)
            top_scratch = max(top_scratch, (2 * p + tail + 1) * d - 1)
        for split, rr in ((head, 0), (tail, nr)):
            if split:
                row = row0 + rr
                first = (row + rp[rr]) // M
                last = (row + rp[rr + 1]) // M
                assert first < last and (rr == 0 or first == p)
                arrivals.append((first, last - first + 1, row, p))
    # the arrivals in a shuffled order: the last at each counter combines
    order = np.random.default_rng(seed).permutation(len(arrivals))
    for i in order:
        first, n, row, _ = arrivals[i]
        top_counter = max(top_counter, first)
        counters[first] += 1
        if counters[first] == n:
            counters[first] = 0
            parts = [scratch[2 * first + 1]] + [scratch[2 * (first + j)]
                                                for j in range(1, n)]
            assert not np.isnan(parts).any()
            write(row, np.sum(parts, axis=0))
    assert not counters.any(), "the counters must be left at 0"
    return out, writes, top_counter, top_scratch


def _plain(x, src, ptr):
    deg = np.diff(ptr)
    out = np.zeros((len(ptr) - 1, x.shape[1]))
    tgt = np.repeat(np.arange(len(deg)), deg)
    np.add.at(out, tgt, x[src[ptr[0]:ptr[-1]]])
    return out


def _plan(kind, num_tgt, num_edges, ptr0=0, pad=0, seed=0):
    """(src, ptr) of a worst plan: `one_row` (one row holds every edge),
    `empty` (every row empty), `boundary` (rows that end exactly on a
    piece boundary), `sparse` (mostly empty rows, a few long ones) or
    `random`; edges start at ptr0 (a shard's or a slice's) and `pad` slots
    follow ptr[-1]."""
    rng = np.random.default_rng(seed)
    deg = np.zeros(num_tgt, np.int64)
    if kind == "one_row":
        deg[num_tgt // 2] = num_edges
    elif kind == "boundary":
        # row t's end item t + ptr[t+1] lands on a multiple of M
        deg[:] = M - 1
    elif kind == "sparse":
        rows = rng.choice(num_tgt, max(1, num_tgt // 50), replace=False)
        np.add.at(deg, rng.choice(rows, num_edges), 1)
    elif kind == "random":
        np.add.at(deg, rng.integers(0, num_tgt, num_edges), 1)
    ptr = np.concatenate([[0], np.cumsum(deg)]) + ptr0
    n_src = 37
    src = rng.integers(0, n_src, ptr0 + int(deg.sum()) + pad)
    return src.astype(np.int32), ptr.astype(np.int32)


@pytest.mark.parametrize("kind", ["one_row", "empty", "boundary", "sparse",
                                  "random"])
@pytest.mark.parametrize("ptr0,pad", [(0, 0), (1000, 333)])
@pytest.mark.parametrize("accumulate", [False, True])
def test_schedule_covers_the_worst_plans(kind, ptr0, pad, accumulate):
    """Every piece, counter and scratch float the kernel touches lies
    within `segsum_schedule`'s sizes for (num_tgt, len(src)); each row is
    written once (K3: once if it has edges, else never) with the plain
    sum."""
    num_tgt = 300 if kind != "boundary" else 40
    num_edges = 0 if kind == "empty" else 5000
    if kind == "boundary":
        num_edges = num_tgt * (M - 1)
    src, ptr = _plan(kind, num_tgt, num_edges, ptr0, pad)
    d = 4
    x = np.random.default_rng(1).standard_normal((37, d))
    sched = sc.segsum_schedule(num_tgt, len(src), d, sm_count=132)
    base = np.random.default_rng(2).standard_normal((num_tgt, d))
    out, writes, top_counter, top_scratch = _model(
        x, src, ptr, sched, accumulate, base if accumulate else None)
    assert top_counter < sched.pieces
    assert top_scratch < sched.scratch_floats
    has_edges = np.diff(ptr) > 0
    if accumulate:
        np.testing.assert_array_equal(writes, has_edges.astype(np.int64))
        np.testing.assert_allclose(out, base + _plain(x, src, ptr),
                                   rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_array_equal(writes, np.ones(num_tgt, np.int64))
        np.testing.assert_allclose(out, _plain(x, src, ptr), rtol=1e-12,
                                   atol=1e-12)
    if kind == "one_row":
        # the row spans many pieces, all summed by one combine
        assert num_edges // M > 10
    if kind == "boundary":
        assert all((t + int(ptr[t + 1]) - ptr0 + 1) % M == 0
                   for t in range(num_tgt))


@pytest.mark.parametrize("num_tgt,num_slots", [
    (1, 0), (1, 1), (127, 1), (128, 0), (1000, 10**6), (10**6, 2 * 10**7),
    (2**31 - 2, 2**31 - 1)])
@pytest.mark.parametrize("sm_count", [1, 132])
def test_schedule_sizes(num_tgt, num_slots, sm_count):
    """The pieces bound ceil((num_tgt + E) / PIECE_ITEMS) for any E <=
    num_slots (the worst plan puts every slot in a row); the grid is at
    least one block, at most BLOCKS_PER_SM per SM and never more blocks
    than it has pieces for; the scratch holds two D-wide parts per piece
    (and the counters, one per piece, number `pieces`)."""
    d = 64
    sched = sc.segsum_schedule(num_tgt, num_slots, d, sm_count)
    need = -(-(num_tgt + num_slots) // sc.PIECE_ITEMS)
    assert sched.pieces == need and sched.scratch_floats == need * 2 * d
    assert 1 <= sched.blocks <= sm_count * sc.BLOCKS_PER_SM
    assert (sched.blocks - 1) * sc.WARPS_PER_BLOCK < need
    # every empty row (E = 0) is still one item of the walk
    assert -(-num_tgt // sc.PIECE_ITEMS) <= sched.pieces


def test_search_finds_every_piece_boundary_in_few_steps():
    """The 16-ary search gives the merge path's row coordinate at every
    item of a skewed plan, in at most ceil(log16(T + 1)) + 1 steps."""
    src, ptr = _plan("sparse", 5000, 20_000, ptr0=7, pad=3, seed=3)
    ptr0, num_tgt = int(ptr[0]), len(ptr) - 1
    num_edges = int(ptr[-1]) - ptr0
    ends = np.arange(num_tgt) + 1 + (ptr[1:] - ptr0)  # item after each end
    worst = 0
    for diag in list(range(0, num_tgt + num_edges + 1, 97)) + [
            num_tgt + num_edges]:
        got, steps = _rows_before(ptr, ptr0, num_tgt, num_edges, diag)
        assert got == int((ends <= diag).sum())
        worst = max(worst, steps)
    assert worst <= int(np.ceil(np.log(num_tgt + 1) / np.log(16))) + 1


def test_kernel_is_compiled_with_this_schedule():
    """The schedule has one source: `_build` compiles csrc/segsum.cu with
    spmm_cuda's constants as -D defines (and hashes them into the
    library's name), and the kernel takes its constants from them."""
    import os
    import re

    from sagnn_tpu_torch.ops import _build

    flags = _build._flags()
    for macro, value in (("SAGNN_PIECE_ITEMS", sc.PIECE_ITEMS),
                         ("SAGNN_WARPS_PER_BLOCK", sc.WARPS_PER_BLOCK),
                         ("SAGNN_BLOCKS_PER_SM", sc.BLOCKS_PER_SM)):
        assert f"-D{macro}={value}" in flags
    with open(os.path.join(_build.CSRC_DIR, "segsum.cu")) as f:
        source = f.read()
    for name, macro in (("kPieceItems", "SAGNN_PIECE_ITEMS"),
                        ("kWarpsPerBlock", "SAGNN_WARPS_PER_BLOCK"),
                        ("kBlocksPerSm", "SAGNN_BLOCKS_PER_SM")):
        assert re.search(rf"constexpr int {name} = {macro};", source), name
