"""Full-sort evaluation in the port against the JAX package: the batches,
the dense and streamed ranks (exactly equal, ties included), the Trainer's
metrics on weights carried across by convert.py, the CLI's --full_sort,
and the ring Trainer over a mesh of four CPU ranks.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagnn_tpu.config import Config as JConfig
from sagnn_tpu.config import ModelConfig as JModelConfig
from sagnn_tpu.config import TrainConfig as JTrainConfig
from sagnn_tpu.data import sampler as jsampler
from sagnn_tpu.data import synthetic as jsynth
from sagnn_tpu.train import metrics as jmetrics
from sagnn_tpu.train.trainer import Trainer as JTrainer
from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch.convert import params_from_numpy
from sagnn_tpu_torch.data import sampler as tsampler
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.parallel.mesh import make_mesh
from sagnn_tpu_torch.train import metrics as tmetrics
from sagnn_tpu_torch.train.trainer import Trainer
from tests.torch_port_helpers import numpy_tree
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KS = (1, 5, 10, 15, 20)
BUNDLE = dict(num_users=48, num_items=64, graph_num=2, test_size=10, seed=2)


# -- batches ------------------------------------------------------------------

@pytest.mark.parametrize("test_mode", [True, False])
def test_full_sort_batch_byte_equal(test_mode):
    """Full-sort batches draw no random numbers: the port's equal JAX's
    byte for byte, a short tail batch included."""
    bundle = jsynth.synthetic_dataset(num_users=60, num_items=90,
                                      graph_num=3, test_size=12, seed=3)
    kw = dict(batch=16, samp_num=4, ssl_num=2, pred_num=3, pos_length=12,
              test_size=12)
    t = tsampler.Sampler(bundle, backend="numpy", **kw)
    j = jsampler.Sampler(bundle, backend="numpy", **kw)
    assert t._max_train_deg == j._max_train_deg
    ids = np.asarray(bundle.tst_usrs)
    for bat in (ids[:16], ids[16:29]):
        got = t.full_sort_batch(bat, test_mode=test_mode)
        want = j.full_sort_batch(bat, test_mode=test_mode)
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # the pad id is past the catalog and the positive is never excluded
    _, pos, _, _, excl, valid = t.full_sort_batch(ids[:16],
                                                  test_mode=test_mode)
    assert (excl <= bundle.num_items).all() and valid.all()
    assert not (excl == pos[:, None]).any()


# -- ranks --------------------------------------------------------------------

def _ranking_inputs(kind, num_items=50, batch=7, dim=8, seed=0):
    """(queries [B, D], items [I, D], pos [B], excl [B, K]) as float32 and
    int32 numpy arrays. "ties": small integers, every second item row a
    copy of another, so scores tie exactly and every sum is exact in f32
    whatever its order; "random": normal values."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        q = rng.integers(-2, 3, (batch, dim)).astype(np.float32)
        items = rng.integers(-2, 3, (num_items, dim)).astype(np.float32)
        items[1::2] = items[rng.integers(0, num_items, num_items // 2) // 2
                            * 2]
    else:
        q = rng.standard_normal((batch, dim)).astype(np.float32)
        items = rng.standard_normal((num_items, dim)).astype(np.float32)
    pos = rng.integers(0, num_items, batch).astype(np.int32)
    excl = np.full((batch, 6), num_items, np.int32)
    for b in range(batch):
        ex = rng.choice(np.setdiff1d(np.arange(num_items), [pos[b]]),
                        rng.integers(0, 6), replace=False)
        excl[b, :len(ex)] = ex
    return q, items, pos, excl


def _dense_scores(q, items, excl):
    s = q.astype(np.float64) @ items.astype(np.float64).T
    s = s.astype(np.float32)
    for b in range(len(q)):
        s[b, excl[b][excl[b] < items.shape[0]]] = -np.inf
    return s


@pytest.mark.parametrize("kind", ["ties", "random"])
def test_full_sort_metrics_match_jax(kind):
    q, items, pos, excl = _ranking_inputs(kind)
    scores = _dense_scores(q, items, excl)
    valid = np.ones(len(q), np.float32)
    valid[-1] = 0.0
    want = jmetrics.full_sort_metrics(jnp.asarray(scores), jnp.asarray(pos),
                                      valid=jnp.asarray(valid), ks=KS)
    got = tmetrics.full_sort_metrics(torch.from_numpy(scores),
                                     torch.from_numpy(pos),
                                     valid=torch.from_numpy(valid), ks=KS)
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == float(want[k]), k
    ranks = tmetrics.full_sort_ranks(torch.from_numpy(scores),
                                     torch.from_numpy(pos)).numpy()
    # brute force: other, non-excluded items scoring >= the positive
    for b in range(len(q)):
        others = np.delete(scores[b], pos[b])
        assert ranks[b] == int((others >= scores[b, pos[b]]).sum())


@pytest.mark.parametrize("kind", ["ties", "random"])
@pytest.mark.parametrize("chunk", [10, 16, 50, 64])
def test_streaming_ranks_match_jax_and_dense(kind, chunk):
    """Exactly JAX's ranks for chunks that divide the 50-item catalog (10,
    50) and chunks that do not (16; 64, wider than it); on exact ties also
    exactly the dense ranks."""
    q, items, pos, excl = _ranking_inputs(kind)
    num_items = items.shape[0]
    want = np.asarray(jmetrics.streaming_positive_ranks(
        jnp.asarray(q), jnp.asarray(items), jnp.asarray(pos),
        jnp.asarray(excl), num_items, chunk_items=chunk))
    got = tmetrics.streaming_positive_ranks(
        torch.from_numpy(q), torch.from_numpy(items), torch.from_numpy(pos),
        torch.from_numpy(excl), num_items, chunk_items=chunk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    dense = tmetrics.dense_positive_ranks(
        torch.from_numpy(q), torch.from_numpy(items), torch.from_numpy(pos),
        torch.from_numpy(excl))
    if kind == "ties":
        # exact sums: both protocols see the same ties, and the dense ranks
        # are those of the -inf-masked scores
        np.testing.assert_array_equal(got.numpy(), dense.numpy())
        np.testing.assert_array_equal(dense.numpy(), tmetrics.full_sort_ranks(
            torch.from_numpy(_dense_scores(q, items, excl)),
            torch.from_numpy(pos)).numpy())


# -- the Trainer --------------------------------------------------------------

def _cfg(backend="pallas", **train):
    model = tcfg.ModelConfig(latdim=16, graph_num=2, gnn_layer=2,
                             att_layer=1, num_heads=4, ssldim=8,
                             pos_length=10, keep_rate=1.0,
                             spmm_backend=backend)
    tc = dict(batch=16, samp_num=4, ssl_num=2, trn_num=32, test_size=10,
              lr=5e-3, reg=1e-2, ssl_reg=1e-3, epoch=1, tst_epoch=1,
              seed=5, save_path="fs", full_sort=True)
    tc.update(train)
    return tcfg.Config(model=model, train=tcfg.TrainConfig(**tc))


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """JAX's Trainer ("xla" backend) on BUNDLE, and its full-sort metrics,
    dense and streamed in 24-item chunks (64 items: not a multiple)."""
    cfg = _cfg("xla")
    jcfg = JConfig(model=JModelConfig(**dataclasses.asdict(cfg.model)),
                   train=JTrainConfig(**dataclasses.asdict(cfg.train)))
    out = {}
    for chunk in (-1, 24):
        jc = jcfg.replace(train=dataclasses.replace(jcfg.train,
                                                    full_sort_chunk=chunk))
        jtr = JTrainer(jc, jsynth.synthetic_dataset(**BUNDLE),
                       ckpt_root=str(tmp_path_factory.mktemp("j")))
        out[chunk] = jtr.test_epoch(full_sort=True)
    return jtr, out


def _port_trainer(tmp_path, jtr, mesh=None, **train):
    backend = "ring" if mesh is not None else "pallas"
    tr = Trainer(_cfg(backend, **train), synthetic_dataset(**BUNDLE),
                 ckpt_root=str(tmp_path), device="cpu", mesh=mesh)
    tr.state["params"] = params_from_numpy(numpy_tree(jtr.state["params"]))
    return tr


@pytest.mark.parametrize("chunk", [-1, 24])
def test_trainer_full_sort_matches_jax(jax_trainer, tmp_path, chunk):
    """test_epoch(full_sort=True) on JAX's weights: dense (-1) and streamed
    (24-item chunks), each against JAX's at rtol 1e-5."""
    jtr, want = jax_trainer
    tr = _port_trainer(tmp_path, jtr, full_sort_chunk=chunk)
    got = tr.test_epoch()
    assert set(got) == set(want[chunk])
    for k, v in want[chunk].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    # the candidate protocol is still there, and differs
    assert tr.test_epoch(full_sort=False)["HR@20"] >= got["HR@20"]


def test_ring_trainer_full_sort_matches_jax(jax_trainer, tmp_path):
    """The ring Trainer over a mesh of four CPU ranks evaluates full-sort
    like JAX's single-device Trainer (dense and streamed)."""
    jtr, want = jax_trainer
    mesh = make_mesh(model=4, devices=["cpu"] * 4)
    for chunk in (-1, 24):
        tr = _port_trainer(tmp_path / str(chunk), jtr, mesh=mesh,
                           full_sort_chunk=chunk)
        got = tr.test_epoch()
        for k, v in want[chunk].items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


def test_cli_full_sort_on_the_cpu(tmp_path):
    cmd = [sys.executable, "-m", "sagnn_tpu_torch.main", "--data",
           "synthetic", "--device", "cpu", "--synth_users", "48",
           "--synth_items", "64", "--graphNum", "2", "--epoch", "1",
           "--trnNum", "32", "--batch", "16", "--testSize", "8",
           "--sslNum", "3", "--sampNum", "4", "--latdim", "16",
           "--num_attention_heads", "4", "--ssldim", "8", "--pos_length",
           "10", "--att_layer", "1", "--tstEpoch", "1", "--spmm_backend",
           "pallas", "--full_sort", "--ckpt_root", str(tmp_path),
           "--save_path", "fs"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Epoch 0/1, Test: HR = " in out.stdout
    assert ", max: " in out.stdout
    assert "sampler: native backend" in out.stdout
