"""The probes' host parts on the CPU: the run-coalescing factor against the
JAX probe's own (scripts/probe_dma_gather.py, loaded by path) on JAX's
plan streams, the CSR-group run and tile factors against a brute force,
P1's and P2's plain versions against numpy, and the wrappers' plain path
for CPU tensors. The kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from sagnn_tpu.ops.spmm_pallas import plan_spmm
from sagnn_tpu_torch.data.graph import compile_interval_graphs
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.ops import probes
from sagnn_tpu_torch.ops import spmm_cuda as sc

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_EPS = float(torch.finfo(torch.float32).eps)


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "probe_dma_gather", os.path.join(ROOT, "scripts",
                                         "probe_dma_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_plan_streams(num_src, num_tgt, edges, seed):
    """The JAX probe's streams (probe_dma_gather.py:219-230): each chunk's
    real sources in JAX's plan_spmm order."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_src, edges, dtype=np.int32)
    tgt = np.sort(rng.integers(0, num_tgt, edges, dtype=np.int32))
    p = plan_spmm(src, tgt, num_tgt, num_edges=edges)
    chunks = p.src.reshape(p.num_chunks, -1)
    real = p.tgt_local < 128
    return [c[m] for c, m in zip(chunks, real) if m.any()]


@pytest.mark.parametrize("fill", [(410, 410, 40_000), (410, 490, 10_000)])
def test_run_coalescing_factor_matches_jax_probe(fill):
    """bench.py's and gowalla's fills at 1/100 scale, as the JAX probe's
    smoke mode draws them."""
    streams = _jax_plan_streams(*fill, seed=0)
    want = _jax_probe().run_coalescing_factor(streams)
    assert probes.run_coalescing_factor(streams) == want
    assert want > 1.0


def _streams(src, ptr, group=32):
    """Each target row's sources cut into `group`-edge groups, in plan
    order: the id streams of the host factors (empty rows give none)."""
    src, ptr = np.asarray(src), np.asarray(ptr)
    return [src[b:min(b + group, ptr[t + 1])]
            for t in range(len(ptr) - 1)
            for b in range(int(ptr[t]), int(ptr[t + 1]), group)]


def _brute_factors(src, ptr):
    streams = _streams(src, ptr)
    e = sum(len(s) for s in streams)
    out = {"edges": e, "streams": len(streams),
           "run": probes.run_coalescing_factor(streams)}
    for w in probes.TILE_WIDTHS:
        out[f"tile{w}"] = e / sum(len(np.unique(s // w)) for s in streams)
    return out


def _port_plans():
    """Interval 0's CSR plans of a small synthetic bundle, both
    directions, and a small bench-fill plan."""
    bundle = synthetic_dataset(num_users=300, num_items=200, graph_num=2,
                               test_size=8, seed=1, seq_len_range=(5, 80))
    gb = compile_interval_graphs(bundle.sub_mats, pad_multiple=16)
    out = []
    for src, tgt, n_tgt in ((gb.u_src, gb.u_tgt, gb.num_users),
                            (gb.i_src, gb.i_tgt, gb.num_items)):
        out.append((src[0], sc.csr_row_ptr(tgt[0], n_tgt)))
    out.append(probes.bench_fill_plan(400, 300, 30_000, seed=3))
    return out


@pytest.mark.parametrize("which", ["u", "i", "bench_fill"])
def test_plan_factors_match_brute_force(which):
    src, ptr = _port_plans()[["u", "i", "bench_fill"].index(which)]
    got = probes.plan_factors(src, ptr)
    want = _brute_factors(src, ptr)
    assert got["edges"] == want["edges"] == int(ptr[-1])
    assert got["streams"] == want["streams"]
    for k in ("run", "tile16", "tile32", "tile64"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    # wider windows share at least as much
    assert 1.0 <= got["tile16"] <= got["tile32"] <= got["tile64"]


def test_streams_cut_rows_into_warp_groups():
    ptr = np.array([0, 0, 70, 71, 71, 135])
    src = np.arange(135)
    streams = _streams(src, ptr)
    assert [len(s) for s in streams] == [32, 32, 6, 1, 32, 32]
    np.testing.assert_array_equal(np.concatenate(streams), src)
    f = probes.plan_factors(src, ptr)
    assert f["streams"] == 6 and f["run"] == 135 / 6


def test_bench_fill_plan_is_target_sorted_with_ascending_rows():
    src, ptr = probes.bench_fill_plan(100, 50, 2_000, seed=0)
    assert ptr[-1] == 2_000 and len(ptr) == 51 and src.max() < 100
    for t in range(50):
        row = src[ptr[t]:ptr[t + 1]]
        assert (np.diff(row) >= 0).all()


@pytest.mark.parametrize("run", probes.RUNS)
def test_probe_ids_are_aligned_runs_sorted_in_chunks(run):
    ids = probes.probe_ids(4096, 8192, run, chunk=256, seed=2)
    assert ids.dtype == np.int32 and len(ids) == 8192 // run
    assert (ids % run == 0).all() and ids.min() >= 0
    assert ids.max() + run <= 4096
    per_chunk = 256 // run
    assert (np.diff(ids.reshape(-1, per_chunk), axis=1) >= 0).all()


@pytest.mark.parametrize("run", probes.RUNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_sum_plain_matches_numpy(run, dtype):
    rng = np.random.default_rng(run)
    x = torch.from_numpy(rng.standard_normal((500, 64)).astype(np.float32))
    x = x.to(dtype)
    src = torch.from_numpy(probes.probe_ids(500, 1024, run, chunk=128))
    rows = (src.numpy()[:, None] + np.arange(run)).reshape(-1)
    want = x.float().numpy().astype(np.float64)[rows].sum(0)
    got = probes.gather_sum_plain(x, src, run)
    assert got.dtype == torch.float32 and got.shape == (64,)
    atol = F32_EPS * len(rows) * float(x.float().abs().max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    # f64 in, f64 sum
    assert probes.gather_sum_plain(x.double(), src, run).dtype == \
        torch.float64


def _ablate_numpy(x, src, ptr):
    out = np.zeros((len(ptr) - 1, x.shape[1]), np.float32)
    for t in range(len(ptr) - 1):
        if ptr[t + 1] > ptr[t]:
            out[t] = x[src[ptr[t + 1] - 1]]
    return out


@pytest.mark.parametrize("exact", [True, False])
def test_segsum_ablate_plain_matches_numpy(exact):
    rng = np.random.default_rng(4)
    deg = rng.integers(0, 5, 300)
    deg[::3] = 0
    ptr = np.zeros(301, np.int64)
    np.cumsum(deg, out=ptr[1:])
    src = rng.integers(0, 120, int(ptr[-1]) + 17).astype(np.int32)
    x = rng.standard_normal((120, 64)).astype(np.float32)
    tx = torch.from_numpy(x)
    table = x if exact else tx.to(torch.bfloat16).float().numpy()
    got = probes.segsum_ablate_plain(tx, torch.from_numpy(src),
                                     torch.from_numpy(ptr.astype(np.int32)),
                                     exact)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _ablate_numpy(table, src, ptr))


def test_wrappers_take_the_plain_path_on_the_cpu():
    """CPU tensors run the plain versions; nothing counts as a launch."""
    probes.reset_launches()
    x = torch.randn(200, 64)
    src = torch.from_numpy(probes.probe_ids(200, 256, 4, chunk=64))
    for k in probes.IN_FLIGHT:
        assert torch.equal(probes.gather_sum(x, src, 4, k),
                           probes.gather_sum_plain(x, src, 4))
    ptr = torch.tensor([0, 3, 3, 7], dtype=torch.int32)
    ids = torch.tensor([5, 1, 9, 0, 2, 2, 8, 4], dtype=torch.int32)
    for exact in (True, False):
        assert torch.equal(probes.segsum_ablate(x, ids, ptr, exact),
                           probes.segsum_ablate_plain(x, ids, ptr, exact))
    assert not any(probes.LAUNCHES.values())
    with pytest.raises(ValueError, match="run 3"):
        probes.gather_sum(x, src, 3)
    with pytest.raises(ValueError, match="in_flight 16"):
        probes.gather_sum(x, src, 1, 16)
    with pytest.raises(ValueError, match="plan has"):
        probes.segsum_ablate(x, ids[:5], ptr)


def test_cli_needs_a_card():
    """The CLI times the card and refuses to run without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA"):
        probes.main([])
