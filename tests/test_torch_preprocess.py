"""The port's preprocessing (`sagnn_tpu_torch/data/preprocess.py`,
`data/io.save_dataset` and `python -m sagnn_tpu_torch.preprocess`)
against the JAX package's on the same seeded raw interactions: every
array, list and dict exactly equal, and the CLIs' pickles byte for byte.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sagnn_tpu.data.io as jio
import sagnn_tpu.data.preprocess as jpp
import sagnn_tpu_torch.data.io as tio
import sagnn_tpu_torch.data.preprocess as tpp
from sagnn_tpu_torch.config import Config, ModelConfig, TrainConfig
from sagnn_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events(seed=0, users=120, items=200, n=3000):
    """Power-law item popularity, uniform users and times."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, users, n).astype(np.int64)
    i = np.minimum((rng.pareto(1.0, n) * 5).astype(np.int64), items - 1)
    t = rng.integers(0, 1_000_000, n).astype(np.int64)
    return u, i, t


def _write_csv(path, u, i, t, prefix=("", "")):
    with open(path, "w") as f:
        f.write("user,item,timestamp\n")
        f.write("\n".join(f"{prefix[0]}{a},{prefix[1]}{b},{c}"
                          for a, b, c in zip(u, i, t)) + "\n")


def assert_same(a, b, where="top"):
    """Equal values and equal types, recursively (sparse matrices by
    format, dtype, shape and entries)."""
    assert type(a) is type(b), (where, type(a), type(b))
    if sp.issparse(a):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert (a != b).nnz == 0, where
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for n, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{n}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k}]")
    else:
        assert a == b, where


def _bundle_parts(b):
    return [b.num_users, b.num_items, b.trn_mat, b.sub_mats, b.time_mat,
            b.sequences, b.tst_int, b.test_dict, b.max_time]


@pytest.mark.parametrize("keys", ["int", "str"])
@pytest.mark.parametrize("min_time", [None, 300_000])
def test_map_ids_matches_jax(keys, min_time):
    u, i, t = _events()
    if keys == "str":
        u = np.array([f"u{x}" for x in u])
        i = np.array([f"i{x}" for x in i])
    want = jpp.map_ids(jpp.RawInteractions(u, i, t), min_time=min_time)
    got = tpp.map_ids(tpp.RawInteractions(u, i, t), min_time=min_time)
    assert_same(list(got), list(want))


@pytest.mark.parametrize("cores", [(0, 0), (5, 3), (20, 15), (500, 1)])
def test_k_core_filter_matches_jax(cores):
    u, i, t = _events(1)
    want = jpp.k_core_filter(u, i, t, *cores)
    got = tpp.k_core_filter(u, i, t, *cores)
    assert_same(list(got), list(want))


def test_leave_one_out_matches_jax():
    u, i, t = _events(2)
    t[::7] = t[3]                       # ties, broken by position
    for num_users in (int(u.max()) + 1, int(u.max()) + 4):  # + empty users
        assert_same(list(tpp.leave_one_out(u, i, t, num_users)),
                    list(jpp.leave_one_out(u, i, t, num_users)))


@pytest.mark.parametrize("num_items,n,seen", [(50, 30, 40), (7, 20, 6),
                                              (40_960, 999, 300),
                                              (10, 0, 3)])
def test_sample_negatives_matches_jax_and_leaves_the_same_rng(num_items, n,
                                                               seen):
    pick = np.random.default_rng(9)
    interacted = set(pick.choice(num_items, seen, replace=False).tolist())
    jr, tr = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(3):
        want = jpp.sample_negatives(jr, num_items, interacted, n)
        got = tpp.sample_negatives(tr, num_items, interacted, n)
        assert_same(got, want)
        assert len(got) == n and not set(got) & interacted
    assert jr.bit_generator.state == tr.bit_generator.state


@pytest.mark.parametrize("graph_num,cores,neg", [(3, (0, 0), 99),
                                                 (4, (3, 2), 20),
                                                 (2, (10, 5), 999)])
def test_preprocess_matches_jax(graph_num, cores, neg):
    u, i, t = _events(3)
    want = jpp.preprocess(u, i, t, graph_num=graph_num, n_negatives=neg,
                          user_core=cores[0], item_core=cores[1], seed=11)
    got = tpp.preprocess(u, i, t, graph_num=graph_num, n_negatives=neg,
                         user_core=cores[0], item_core=cores[1], seed=11)
    assert_same(_bundle_parts(got), _bundle_parts(want))
    for pct, seed in ((0.1, 0), (0.5, 7)):
        assert_same(tpp.add_noise(got, pct, seed=seed),
                    jpp.add_noise(want, pct, seed=seed))


def test_save_dataset_loads_in_both_packages(tmp_path):
    u, i, t = _events(4)
    bundle = tpp.preprocess(u, i, t, graph_num=3, n_negatives=30)
    tio.save_dataset(str(tmp_path / "t"), bundle, full_mat=bundle.time_mat)
    jbundle = jpp.preprocess(u, i, t, graph_num=3, n_negatives=30)
    jio.save_dataset(str(tmp_path / "j"), jbundle, full_mat=jbundle.time_mat)
    for name in ("trn_mat_time", "tst_int", "sequence", "test_dict"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    got_t = tio.load_dataset(str(tmp_path / "t"))
    got_j = jio.load_dataset(str(tmp_path / "t"))
    assert_same(_bundle_parts(got_t), _bundle_parts(got_j))
    assert_same(_bundle_parts(got_t), _bundle_parts(bundle))


def test_cli_writes_the_jax_scripts_pickles(tmp_path):
    """python -m sagnn_tpu_torch.preprocess and scripts/preprocess.py on
    the same CSV: the same files, byte for byte, noise payload included
    (string keys, read by genfromtxt, in test_from_csv_matches_jax)."""
    csv = tmp_path / "raw.csv"
    _write_csv(csv, *_events(5))
    flags = ["--csv", str(csv), "--graph_num", "3", "--user_core", "3",
             "--item_core", "2", "--n_negatives", "50", "--noise", "0.1",
             "--min_time", "100000"]
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    for cmd, out in (([sys.executable, "scripts/preprocess.py"], "j"),
                     ([sys.executable, "-m", "sagnn_tpu_torch.preprocess"],
                      "t")):
        r = subprocess.run(cmd + flags + ["--out", str(tmp_path / out)],
                           cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == ["noise_0.10", "sequence", "test_dict", "trn_mat_time",
                     "tst_int"]
    assert sorted(os.listdir(tmp_path / "t")) == names
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


def test_from_csv_matches_jax(tmp_path):
    u, i, t = _events(6, n=500)
    for prefix in (("", ""), ("u", "")):
        csv = tmp_path / f"raw{prefix[0]}.csv"
        _write_csv(csv, u, i, t, prefix=prefix)
        want = jpp.RawInteractions.from_csv(str(csv))
        got = tpp.RawInteractions.from_csv(str(csv))
        assert_same([got.users, got.items, got.times],
                    [want.users, want.items, want.times])


def test_preprocessed_bundle_trains_a_step(tmp_path):
    u, i, t = _events(7, users=48, items=64, n=1500)
    bundle = tpp.preprocess(u, i, t, graph_num=2, n_negatives=9,
                            user_core=2, item_core=2)
    tio.save_dataset(str(tmp_path / "d"), bundle, full_mat=bundle.time_mat)
    bundle = tio.load_dataset(str(tmp_path / "d"))
    cfg = Config(
        model=ModelConfig(graph_num=2, gnn_layer=1, att_layer=1, latdim=8,
                          num_heads=2, ssldim=4, pos_length=8,
                          spmm_backend="pallas"),
        train=TrainConfig(batch=8, samp_num=3, ssl_num=2, trn_num=16,
                          test_size=10))
    tr = Trainer(cfg, bundle, ckpt_root=str(tmp_path), device="cpu")
    ids = tr.sampler.epoch_user_ids(16)[:8]
    losses = tr.train_step(tr.sampler.train_batch(ids).to("cpu"))
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert tr.state["step"] == 1
    assert 0.0 <= tr.test_epoch(max_users=16)["HR"] <= 1.0
    assert isinstance(losses["loss"], torch.Tensor)
