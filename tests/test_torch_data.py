"""The port's host data layer gives the JAX package's arrays, byte for
byte, from the same seed."""

import numpy as np
import pytest
import torch

from sagnn_tpu.data import graph as jgraph
from sagnn_tpu.data import io as jio
from sagnn_tpu.data import sampler as jsampler
from sagnn_tpu.data import synthetic as jsynth
from sagnn_tpu_torch.data import graph as tgraph
from sagnn_tpu_torch.data import io as tio
from sagnn_tpu_torch.data import sampler as tsampler
from sagnn_tpu_torch.data import synthetic as tsynth
from sagnn_tpu_torch.ops.spmm_cuda import build_stacked_plans, csr_row_ptr

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

SIZES = [dict(num_users=40, num_items=70, graph_num=3, test_size=12, seed=3),
         dict(num_users=25, num_items=30, graph_num=2, test_size=8, seed=11,
              seq_len_range=(2, 9))]


def _assert_csr_equal(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape
    for name in ("indptr", "indices", "data"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def _assert_bundles_equal(t, j):
    assert (t.num_users, t.num_items, t.max_time) == \
        (j.num_users, j.num_items, j.max_time)
    _assert_csr_equal(t.trn_mat, j.trn_mat)
    assert len(t.sub_mats) == len(j.sub_mats)
    for a, b in zip(t.sub_mats, j.sub_mats):
        _assert_csr_equal(a, b)
    assert t.sequences == j.sequences
    assert list(t.tst_int) == list(j.tst_int)
    assert t.test_dict == j.test_dict
    assert np.array_equal(t.tst_usrs, j.tst_usrs)


@pytest.mark.parametrize("kw", SIZES)
def test_synthetic_dataset_byte_equal(kw):
    t = tsynth.synthetic_dataset(**kw)
    j = jsynth.synthetic_dataset(**kw)
    _assert_bundles_equal(t, j)
    _assert_csr_equal(t.time_mat, j.time_mat)


@pytest.mark.parametrize("kw", SIZES)
@pytest.mark.parametrize("pad", [8, 512])
def test_compile_interval_graphs_byte_equal(kw, pad):
    bundle = jsynth.synthetic_dataset(**kw)
    t = tgraph.compile_interval_graphs(bundle.sub_mats, pad_multiple=pad)
    j = jgraph.compile_interval_graphs(bundle.sub_mats, pad_multiple=pad)
    for name in ("u_src", "u_tgt", "i_src", "i_tgt", "edge_counts"):
        x, y = getattr(t, name), getattr(j, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert (t.num_users, t.num_items, t.edges_padded, t.total_edges) == \
        (j.num_users, j.num_items, j.edges_padded, j.total_edges)


def test_load_dataset_reads_what_jax_saved(tmp_path):
    bundle = jsynth.synthetic_dataset(**SIZES[0])
    jio.save_dataset(str(tmp_path), bundle)
    _assert_bundles_equal(tio.load_dataset(str(tmp_path)),
                          jio.load_dataset(str(tmp_path)))


@pytest.mark.parametrize("test_mode", [True, False])
def test_test_batch_byte_equal(test_mode):
    kw = SIZES[0]
    bundle = jsynth.synthetic_dataset(**kw)
    batch, pos_length = 16, 10
    js = jsampler.Sampler(bundle, batch=batch, samp_num=4, ssl_num=2,
                          pred_num=3, pos_length=pos_length,
                          test_size=kw["test_size"], backend="numpy")
    ids = np.asarray(bundle.tst_usrs)[:13]   # a short tail batch
    want = js.test_batch(ids, test_mode=test_mode)
    got = tsampler.test_batch(bundle, ids, kw["test_size"], pos_length,
                              test_mode=test_mode, batch_cap=batch)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_user_sequences_match_fill_sequence():
    bundle = jsynth.synthetic_dataset(**SIZES[1])
    users = np.array([0, 3, 7, 24])
    seq, mask = tsampler.user_sequences(bundle, users, 5)
    for i, u in enumerate(users):
        s, m = jsampler._fill_sequence(bundle.sequences[u], 5)
        assert np.array_equal(seq[i], s) and np.array_equal(mask[i], m)


@pytest.mark.parametrize("kw", SIZES)
def test_csr_plan_rows_reproduce_coo_targets(kw):
    bundle = jsynth.synthetic_dataset(**kw)
    gb = tgraph.compile_interval_graphs(bundle.sub_mats, pad_multiple=8)
    plans = build_stacked_plans(gb.u_src, gb.u_tgt, gb.i_src, gb.i_tgt,
                                gb.num_users, gb.num_items)
    for d, tgt, n in (("u", gb.u_tgt, gb.num_users),
                      ("i", gb.i_tgt, gb.num_items)):
        ptr = plans[f"{d}_ptr"]
        assert ptr.dtype == np.int32 and ptr.shape == (gb.graph_num, n + 1)
        for k in range(gb.graph_num):
            e = int(gb.edge_counts[k])
            assert ptr[k, 0] == 0 and ptr[k, -1] == e
            rows = np.repeat(np.arange(n), np.diff(ptr[k]))
            assert np.array_equal(rows, tgt[k, :e])
            assert (tgt[k, e:] == n).all()      # pads after ptr[n]


def test_csr_row_ptr_edge_cases():
    assert np.array_equal(csr_row_ptr(np.zeros(0, np.int32), 3),
                          np.zeros(4, np.int32))
    # all-padding interval (the empty-graph convention)
    assert np.array_equal(csr_row_ptr(np.full(8, 3, np.int32), 3),
                          np.zeros(4, np.int32))
    assert np.array_equal(csr_row_ptr(np.array([0, 0, 2, 3, 3]), 3),
                          np.array([0, 2, 2, 3], np.int32))
    with pytest.raises(ValueError):
        csr_row_ptr(np.array([1, 0]), 2)
    with pytest.raises(ValueError):
        build_stacked_plans(np.array([[5]], np.int32),
                            np.array([[0]], np.int32),
                            np.array([[0]], np.int32),
                            np.array([[0]], np.int32), 1, 3)


def test_spmm_plain_sees_no_pad_edges():
    """Pad edges (src 0, tgt num_tgt) after ptr[num_tgt] never reach the
    sum, even when the pad source row holds large values."""
    from sagnn_tpu_torch.ops.spmm_cuda import spmm_apply
    src = np.array([1, 2, 1, 0, 0, 0], np.int32)
    tgt = np.array([0, 0, 2, 3, 3, 3], np.int32)
    ptr = torch.from_numpy(csr_row_ptr(tgt, 3))
    x = torch.tensor([[1e6, 1e6], [1.0, 2.0], [3.0, 4.0]])
    out = spmm_apply(x, torch.from_numpy(src), ptr)
    assert torch.equal(out, torch.tensor([[4.0, 6.0], [0.0, 0.0],
                                          [1.0, 2.0]]))


def test_spmm_rejects_a_plan_longer_than_its_source_ids():
    from sagnn_tpu_torch.ops.spmm_cuda import spmm_apply
    ptr = torch.from_numpy(csr_row_ptr(np.array([0, 0, 1, 2], np.int32), 3))
    x = torch.ones((3, 2))
    assert spmm_apply(x, torch.zeros(4, dtype=torch.int32), ptr).shape \
        == (3, 2)
    with pytest.raises(ValueError, match="4 edges, src 3"):
        spmm_apply(x, torch.zeros(3, dtype=torch.int32), ptr)
