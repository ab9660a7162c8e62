"""The port's training sampler gives the JAX package's numpy sampler's
arrays, byte for byte, for the same seed and call sequence.

The JAX side is built with backend="numpy": its default ("auto") loads the
native C++ sampler when its library is built, and that one draws other
numbers.
"""

import dataclasses

import numpy as np
import pytest

from sagnn_tpu.data import sampler as jsampler
from sagnn_tpu.data import synthetic as jsynth
from sagnn_tpu_torch.data import sampler as tsampler
from sagnn_tpu_torch.models.selfgnn import TrainBatch

# (bundle kwargs, sampler kwargs): the second bundle has short sequences,
# so some users have few or no SSL pairs and short train rows
CASES = [
    (dict(num_users=60, num_items=90, graph_num=3, test_size=12, seed=3),
     dict(batch=16, samp_num=5, ssl_num=4, pred_num=5, pos_length=12,
          test_size=12, seed=7)),
    (dict(num_users=30, num_items=40, graph_num=2, test_size=8, seed=11,
          seq_len_range=(2, 9)),
     dict(batch=8, samp_num=6, ssl_num=3, pred_num=3, pos_length=6,
          test_size=8, seed=100)),
]


def _pair(case):
    bkw, skw = case
    bundle = jsynth.synthetic_dataset(**bkw)
    return (tsampler.Sampler(bundle, **skw),
            jsampler.Sampler(bundle, backend="numpy", **skw))


def _assert_same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert np.array_equal(got, want), what


@pytest.mark.parametrize("case", CASES)
def test_train_batches_byte_equal(case):
    """An epoch permutation and three successive train batches (each draws
    its own batch and SSL seeds from the shared generator)."""
    t, j = _pair(case)
    trn_num = 3 * t.batch
    ids_t, ids_j = t.epoch_user_ids(trn_num), j.epoch_user_ids(trn_num)
    _assert_same(ids_t, ids_j, "epoch_user_ids")
    for s in range(3):
        bat = ids_t[s * t.batch:(s + 1) * t.batch]
        bt, bj = t.train_batch(bat), j.train_batch(bat)
        assert isinstance(bt, TrainBatch)
        for f in dataclasses.fields(TrainBatch):
            _assert_same(getattr(bt, f.name), np.asarray(getattr(bj, f.name)),
                         f"batch {s}: {f.name}")
    # the generators end in the same state
    assert t.rng.bit_generator.state == j.rng.bit_generator.state


@pytest.mark.parametrize("case", CASES)
def test_ssl_batches_byte_equal(case):
    t, j = _pair(case)
    ids = np.arange(t.bundle.num_users)[:t.batch]
    for _ in range(3):
        st, sj = t.ssl_batch(ids), j.ssl_batch(ids)
        assert set(st) == set(sj)
        for k in st:
            _assert_same(st[k], sj[k], k)


@pytest.mark.parametrize("case", CASES)
def test_short_batch_is_padded(case):
    """A last batch shorter than `batch` fills the fixed-size arrays with
    masked padding, as the JAX sampler does."""
    t, j = _pair(case)
    bat = t.epoch_user_ids(t.batch)[: t.batch - 3]
    j.epoch_user_ids(t.batch)               # the same stream position
    bt, bj = t.train_batch(bat), j.train_batch(bat)
    assert bt.uids.shape == (t.batch * t.samp_num,)
    assert not bt.pair_mask[len(bat) * t.samp_num:].any()
    for f in dataclasses.fields(TrainBatch):
        _assert_same(getattr(bt, f.name), np.asarray(getattr(bj, f.name)),
                     f.name)


def test_negatives_avoid_the_train_row_and_the_held_out_items():
    bundle = jsynth.synthetic_dataset(num_users=50, num_items=60,
                                      graph_num=2, test_size=8, seed=5)
    t = tsampler.Sampler(bundle, batch=50, samp_num=8, ssl_num=2,
                         pred_num=4, pos_length=10, test_size=8, seed=1)
    b = t.train_batch(np.arange(50))
    csr = bundle.trn_mat.tocsr()
    real = b.pair_mask > 0
    for u, neg in zip(b.uids[real], b.neg_iids[real]):
        assert csr[u, neg] == 0
        assert neg != bundle.sequences[u][-1] and neg != bundle.tst_int[u]
    # the per-user mask of seen items is cleared after every user
    assert not t._seen.any()


def test_neg_sample_matches_jax():
    rng_row = np.random.default_rng(0)
    seen = rng_row.random(200) < 0.3
    got = tsampler.neg_sample(np.random.default_rng(9), seen, 25, 200,
                              (3, None))
    want = jsampler.neg_sample(np.random.default_rng(9),
                               seen.astype(np.float32), 25, 200, (3, None))
    _assert_same(got, want, "negatives")
    assert not seen[got].any() and (got != 3).all()
