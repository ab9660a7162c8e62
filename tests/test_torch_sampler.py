"""The port's training sampler gives the JAX package's sampler's arrays,
byte for byte, for the same seed, call sequence and backend: "numpy" on
both sides, and "native" (each package's copy of sampler.cc, built by its
own build) on both sides. The two backends draw other numbers from each
other, so each test runs as one case per backend.
"""

import dataclasses
import os

import numpy as np
import pytest

from sagnn_tpu.data import sampler as jsampler
from sagnn_tpu.data import synthetic as jsynth
from sagnn_tpu_torch.data import native_sampler as tnative
from sagnn_tpu_torch.data import sampler as tsampler
from sagnn_tpu_torch.models.selfgnn import TrainBatch

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

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


BACKENDS = ["numpy", "native"]


def _pair(case, backend):
    bkw, skw = case
    bundle = jsynth.synthetic_dataset(**bkw)
    t = tsampler.Sampler(bundle, backend=backend, **skw)
    assert t.backend == backend
    return t, jsampler.Sampler(bundle, backend=backend, **skw)


def _assert_same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert np.array_equal(got, want), what


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES)
def test_train_batches_byte_equal(case, backend):
    """An epoch permutation and three successive train batches (each draws
    its own batch and SSL seeds from the shared generator)."""
    t, j = _pair(case, backend)
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


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES)
def test_ssl_batches_byte_equal(case, backend):
    t, j = _pair(case, backend)
    ids = np.arange(t.bundle.num_users)[:t.batch]
    for _ in range(3):
        st, sj = t.ssl_batch(ids), j.ssl_batch(ids)
        assert set(st) == set(sj)
        for k in st:
            _assert_same(st[k], sj[k], k)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES)
def test_short_batch_is_padded(case, backend):
    """A last batch shorter than `batch` fills the fixed-size arrays with
    masked padding, as the JAX sampler does."""
    t, j = _pair(case, backend)
    bat = t.epoch_user_ids(t.batch)[: t.batch - 3]
    j.epoch_user_ids(t.batch)               # the same stream position
    bt, bj = t.train_batch(bat), j.train_batch(bat)
    assert bt.uids.shape == (t.batch * t.samp_num,)
    assert not bt.pair_mask[len(bat) * t.samp_num:].any()
    for f in dataclasses.fields(TrainBatch):
        _assert_same(getattr(bt, f.name), np.asarray(getattr(bj, f.name)),
                     f.name)


@pytest.mark.parametrize("backend", BACKENDS)
def test_negatives_avoid_the_train_row_and_the_held_out_items(backend):
    bundle = jsynth.synthetic_dataset(num_users=50, num_items=60,
                                      graph_num=2, test_size=8, seed=5)
    t = tsampler.Sampler(bundle, batch=50, samp_num=8, ssl_num=2,
                         pred_num=4, pos_length=10, test_size=8, seed=1,
                         backend=backend)
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


def _without_a_compiler(monkeypatch, tmp_path):
    """No library built yet (an empty build folder) and no compiler."""
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))


def test_native_backend_raises_without_a_compiler(monkeypatch, tmp_path):
    _without_a_compiler(monkeypatch, tmp_path)
    bundle = jsynth.synthetic_dataset(**CASES[0][0])
    with pytest.raises(RuntimeError, match="compiler"):
        tsampler.Sampler(bundle, backend="native", **CASES[0][1])


def test_auto_backend_falls_back_to_numpy_and_says_so(monkeypatch, tmp_path,
                                                     capsys):
    bundle = jsynth.synthetic_dataset(**CASES[0][0])
    assert tsampler.Sampler(bundle, **CASES[0][1]).backend == "native"
    _without_a_compiler(monkeypatch, tmp_path)
    t = tsampler.Sampler(bundle, **CASES[0][1])
    assert t.backend == "numpy"
    out = capsys.readouterr().out
    assert "native library unavailable" in out
    assert "sampler: numpy backend" in out
    with pytest.raises(ValueError, match="backend"):
        tsampler.Sampler(bundle, backend="cuda", **CASES[0][1])


def test_native_library_is_named_by_its_source(monkeypatch, tmp_path):
    """An edited source (or other flags) names another library, so a
    library built from an older source is never loaded."""
    path = tnative.library_path()
    src = tmp_path / "sampler.cc"
    with open(tnative.SOURCE) as f:
        src.write_text(f.read() + "\n// edited\n")
    monkeypatch.setattr(tnative, "SOURCE", str(src))
    assert tnative.library_path() != path
    monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS[1:])
    assert os.path.basename(tnative.library_path()) != \
        os.path.basename(path)
