"""The port's catalog-sharded serving (`sagnn_tpu_torch/parallel/
serving.py`) on a mesh of 8 CPU ranks against JAX's on the 8-device CPU
mesh of tests/conftest.py, against the port's single-device top-k, and
the serve CLI on a checkpoint a CPU Trainer saved.

The bound is JAX's own test's (tests/test_serving_sharded.py): values
within rtol 1e-5 and atol 1e-5; ids equal wherever the score is more than
that away from its neighbours in the exact ranking; no pad id returned.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from sagnn_tpu.parallel.serving import pad_catalog as j_pad_catalog
from sagnn_tpu.parallel.serving import shard_catalog as j_shard_catalog
from sagnn_tpu.parallel.serving import (
    sharded_recommend_top_k as j_sharded_recommend_top_k)
from sagnn_tpu.parallel.serving import sharded_topk as j_sharded_topk
from sagnn_tpu_torch import serve as tserve
from sagnn_tpu_torch.config import Config, ModelConfig, TrainConfig
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.parallel.mesh import make_mesh
from sagnn_tpu_torch.parallel.serving import (pad_catalog, shard_catalog,
                                              sharded_recommend_top_k,
                                              sharded_topk)
from sagnn_tpu_torch.train.trainer import Trainer

from sagnn_tpu.models.selfgnn import SelfGNN as JaxSelfGNN
from sagnn_tpu_torch.convert import params_from_numpy
from sagnn_tpu_torch.data.graph import compile_interval_graphs as t_compile
from sagnn_tpu_torch.models.selfgnn import SelfGNN as TorchSelfGNN
from sagnn_tpu_torch.models.selfgnn import graphs_to_device

from tests.torch_port_helpers import MCFG, numpy_tree, torch_cfg

TOL = 1e-5
RANKS = 8


def cpu_mesh(n=RANKS):
    return make_mesh(data=1, model=n, devices=["cpu"] * n)


def exact_scores(q, table, num_items, seq=None, msk=None):
    """f64 scores [B, num_items] with each user's seen items at -inf."""
    s = q.astype(np.float64) @ table[:num_items].astype(np.float64).T
    if seq is not None:
        for b in range(len(s)):
            s[b, seq[b][msk[b] > 0]] = -np.inf
    return s


def check_topk(v, i, scores, k, num_items, what=""):
    """Values against the exact top-k, the scores at the returned ids,
    ids where the ranking has no tie within the bound, no pad id."""
    v, i = np.asarray(v, np.float64), np.asarray(i)
    order = np.argsort(-scores, axis=1, kind="stable")
    want_v = np.take_along_axis(scores, order, 1)
    np.testing.assert_allclose(v, want_v[:, :k], rtol=TOL, atol=TOL,
                               err_msg=what)
    np.testing.assert_allclose(np.take_along_axis(scores, i, 1), v,
                               rtol=TOL, atol=TOL, err_msg=what)
    assert int(i.max()) < num_items and int(i.min()) >= 0, what
    pad = np.full((len(v), 1), np.inf)
    w = np.concatenate([pad, want_v[:, :k + 1], -pad], 1)
    gap = np.minimum(np.abs(w[:, 1:k + 1] - w[:, :k]),
                     np.abs(w[:, 2:k + 2] - w[:, 1:k + 1]))
    clear = gap > TOL + TOL * np.abs(w[:, 1:k + 1])
    assert clear.any(), what
    np.testing.assert_array_equal(i[clear], order[:, :k][clear],
                                  err_msg=what)


def _inputs(seed, num_items, B=6, D=16, L=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    table = rng.standard_normal((num_items, D)).astype(np.float32)
    seq = rng.integers(0, num_items, (B, L)).astype(np.int32)
    msk = (rng.random((B, L)) > 0.4).astype(np.float32)
    return q, table, seq, msk


@pytest.mark.parametrize("num_items,exclude,chunk_rows", [
    (50, False, -1), (53, True, -1), (50, True, 7), (53, False, 4)])
def test_sharded_topk_matches_jax(num_items, exclude, chunk_rows):
    """Catalogs that do and do not divide 8 ranks, with and without
    exclusion, dense and streamed, against JAX's sharded_topk; the port
    also streams in other chunk sizes against the exact ranking."""
    q, table, seq, msk = _inputs(3 + num_items, num_items)
    k = 7
    ex = dict(seen_seq=seq, seen_mask=msk) if exclude else {}
    jm = j_make_mesh(data=1, model=RANKS)
    jv, ji = j_sharded_topk(
        jm, jnp.asarray(q), j_shard_catalog(jm, j_pad_catalog(table, RANKS)),
        num_items, k, chunk_rows=chunk_rows,
        **{a: jnp.asarray(b) for a, b in ex.items()})
    scores = exact_scores(q, table, num_items, *((seq, msk) if exclude
                                                 else ()))
    check_topk(jv, ji, scores, k, num_items, "jax")
    mesh = cpu_mesh()
    table_t = shard_catalog(mesh, pad_catalog(torch.from_numpy(table),
                                              RANKS))
    for chunk in (chunk_rows, -1, 4, 7, 64):
        tv, ti = sharded_topk(
            mesh, torch.from_numpy(q), table_t, num_items, k,
            chunk_rows=chunk,
            **{a: torch.from_numpy(b) for a, b in ex.items()})
        check_topk(tv, ti, scores, k, num_items, f"port, chunk {chunk}")
        if chunk == chunk_rows:
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("chunk_rows", [-1, 16])
def test_sharded_topk_empty_shards(chunk_rows):
    """Only rank 0 holds real rows (37 items in 8 x 128 rows): the other
    ranks offer nothing and no pad id comes back (JAX's case)."""
    num_items, k = 37, 10
    q, table, seq, msk = _inputs(11, num_items, B=4)
    big = np.zeros((1024, table.shape[1]), np.float32)
    big[:num_items] = table
    jm = j_make_mesh(data=1, model=RANKS)
    jv, ji = j_sharded_topk(jm, jnp.asarray(q), j_shard_catalog(jm, big),
                            num_items, k, seen_seq=jnp.asarray(seq),
                            seen_mask=jnp.asarray(msk),
                            chunk_rows=chunk_rows)
    mesh = cpu_mesh()
    tv, ti = sharded_topk(mesh, torch.from_numpy(q),
                          shard_catalog(mesh, torch.from_numpy(big)),
                          num_items, k, seen_seq=torch.from_numpy(seq),
                          seen_mask=torch.from_numpy(msk),
                          chunk_rows=chunk_rows)
    scores = exact_scores(q, table, num_items, seq, msk)
    check_topk(tv, ti, scores, k, num_items, "port")
    check_topk(jv, ji, scores, k, num_items, "jax")
    # k = num_items: every real item, none of the pad rows
    for chunk in (chunk_rows, 64):
        v, i = sharded_topk(mesh, torch.from_numpy(q),
                            shard_catalog(mesh, torch.from_numpy(big)),
                            num_items, num_items, chunk_rows=chunk)
        assert sorted(i[0].tolist()) == list(range(num_items))


def test_pad_and_shard_catalog():
    t = torch.arange(53 * 2, dtype=torch.float32).reshape(53, 2)
    p = pad_catalog(t, 8)
    np.testing.assert_array_equal(p.numpy(), j_pad_catalog(t.numpy(), 8))
    assert pad_catalog(p, 8) is p
    blocks = shard_catalog(cpu_mesh(), p)
    assert [tuple(b.shape) for b in blocks] == [(7, 2)] * 8
    assert torch.equal(torch.cat(blocks), p)
    assert blocks[0].data_ptr() != p.data_ptr()   # a new buffer per rank
    with pytest.raises(ValueError):
        shard_catalog(cpu_mesh(), t)
    with pytest.raises(ValueError):
        sharded_topk(cpu_mesh(), torch.zeros(1, 2), blocks, 53, 54)


@pytest.fixture(scope="module")
def env():
    """JAX's weights (non-trivial biases) carried to the port with
    convert.py, the port's model, graphs and encodings."""
    bundle = synthetic_dataset(num_users=40, num_items=53,
                               graph_num=MCFG.graph_num, test_size=9, seed=4)
    jm = JaxSelfGNN(MCFG, bundle.num_users, bundle.num_items)
    rng = np.random.default_rng(2)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(
            0, 0.05, a.shape).astype(np.float32)),
        jm.init(jax.random.PRNGKey(2)))
    tm = TorchSelfGNN(torch_cfg(MCFG), bundle.num_users, bundle.num_items)
    tg = graphs_to_device(t_compile(bundle.sub_mats, pad_multiple=8), "cpu")
    tp = params_from_numpy(numpy_tree(jp))
    return bundle, jm, jp, tm, tg, tp


@pytest.mark.parametrize("exclude,chunk_rows", [(True, 0), (False, 5)])
def test_sharded_recommend_matches_single_device_and_jax(env, exclude,
                                                         chunk_rows):
    """sharded_recommend_top_k against the port's recommend_top_k and
    against JAX's sharded_recommend_top_k, on the same weights and
    encodings (the encode is held against JAX's in test_torch_model)."""
    bundle, jm, jp, tm, tg, tp = env
    rng = np.random.default_rng(0)
    B, k, L = 6, 8, tm.cfg.pos_length
    users = rng.integers(0, bundle.num_users, B).astype(np.int32)
    seq = rng.integers(0, bundle.num_items, (B, L)).astype(np.int32)
    mask = (rng.random((B, L)) > 0.4).astype(np.float32)
    t_args = [torch.from_numpy(a) for a in (users, seq, mask)]
    fu, fi, _, _ = tm.encode(tp, tg)
    mesh = cpu_mesh()
    got_v, got_i = sharded_recommend_top_k(
        tm, mesh, tp, fu, fi, *t_args, k=k, exclude_seen=exclude,
        chunk_rows=chunk_rows)
    want_v, want_i = tm.recommend_top_k(tp, tg, *t_args, k=k,
                                        exclude_seen=exclude,
                                        encodings=(fu, fi))
    queries = tm.serving_queries(tp, fu, fi, *t_args).numpy()
    scores = exact_scores(queries, fi.numpy(), bundle.num_items,
                          *((seq, mask) if exclude else ()))
    check_topk(got_v, got_i, scores, k, bundle.num_items, "sharded")
    check_topk(want_v, want_i, scores, k, bundle.num_items, "single")

    jmesh = j_make_mesh(data=1, model=RANKS)
    jv, ji = j_sharded_recommend_top_k(
        jm, jmesh, jp, jnp.asarray(fu.numpy()), jnp.asarray(fi.numpy()),
        *(jnp.asarray(a) for a in (users, seq, mask)),
        k=k, exclude_seen=exclude, chunk_rows=chunk_rows)
    check_topk(jv, ji, scores, k, bundle.num_items, "jax")
    np.testing.assert_allclose(got_v.numpy(), np.asarray(jv), rtol=TOL,
                               atol=TOL)


def test_catalog_mesh_on_the_cpu():
    m = tserve.catalog_mesh(4, "cpu")
    assert m.shape == {"data": 1, "model": 4}
    assert [d.type for d in m.model_devices] == ["cpu"] * 4


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A CPU Trainer's checkpoint after one epoch on a synthetic set the
    serve CLI rebuilds from the checkpoint's config (its train seed)."""
    root = tmp_path_factory.mktemp("ckpt")
    cfg = Config(
        model=ModelConfig(latdim=16, graph_num=2, gnn_layer=2, att_layer=1,
                          num_heads=4, ssldim=8, pos_length=10,
                          spmm_backend="pallas"),
        train=TrainConfig(batch=16, trn_num=32, samp_num=4, ssl_num=3,
                          test_size=8, seed=5, save_path="served"))
    bundle = synthetic_dataset(num_users=48, num_items=61, graph_num=2,
                               test_size=8, seed=5)
    tr = Trainer(cfg, bundle, ckpt_root=str(root), device="cpu")
    tr.train_epoch(verbose=False)
    tr.ckpt.save(tr.state, tr.history, tr.cfg)
    return root, tr


def _serve(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tserve.main(argv)
    return [json.loads(x) for x in buf.getvalue().splitlines()]


@pytest.mark.parametrize("shards", [0, 4])
def test_cli_serves_a_trained_checkpoint(checkpoint, shards):
    """--ckpt_root/--save_path rebuild the model from config.json and
    restore the trained params; --catalog_shards 4 gives the same top-k."""
    root, tr = checkpoint
    users = [0, 3, 7, 20]
    argv = ["--data", "synthetic", "--synth_users", "48", "--synth_items",
            "61", "--ckpt_root", str(root), "--save_path", "served",
            "--device", "cpu", "--k", "6", "--users"] + \
        [str(u) for u in users]
    if shards:
        argv += ["--catalog_shards", str(shards)]
    got = _serve(argv)
    assert [g["user"] for g in got] == users

    rec = tserve.Recommender.from_checkpoint(str(root), "served", tr.bundle,
                                             device="cpu")
    for k, v in tr.state["params"].items():
        assert torch.equal(rec.params[k], v.detach()), k
    assert rec.cfg.model == tr.cfg.model
    from sagnn_tpu_torch.data.sampler import user_sequences
    seq, mask = user_sequences(tr.bundle, np.asarray(users), 10)
    fu, fi = rec.encodings
    queries = rec.model.serving_queries(
        rec.params, fu, fi, torch.tensor(users), torch.from_numpy(seq),
        torch.from_numpy(mask)).numpy()
    scores = exact_scores(queries, fi.numpy(), 61, seq, mask)
    v = np.array([g["scores"] for g in got])
    i = np.array([g["items"] for g in got])
    # the CLI prints scores rounded to 4 decimals
    np.testing.assert_allclose(v, np.sort(scores, 1)[:, ::-1][:, :6],
                               atol=1e-4)
    vv, ii = rec.recommend(users, k=6)
    check_topk(vv, ii, scores, 6, 61, "Recommender")
    np.testing.assert_array_equal(i, ii.numpy())


def test_cli_without_a_checkpoint_exits_1(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        tserve.main(["--data", "synthetic", "--ckpt_root", str(tmp_path),
                     "--save_path", "none", "--device", "cpu", "--users",
                     "0"])
    assert e.value.code == 1
    assert "no checkpoint" in capsys.readouterr().err
    assert not (tmp_path / "none").exists()


@pytest.mark.parametrize("flag", [["--edge_norm", "mean"],
                                  ["--edge_attention"],
                                  ["--params", "w.npz"]])
def test_cli_refuses_model_flags_with_a_checkpoint(checkpoint, flag):
    """The checkpoint's config.json and weights define the model: flags
    that would change them are an error, not silently dropped."""
    root, _ = checkpoint
    with pytest.raises(SystemExit) as e:
        tserve.main(["--data", "synthetic", "--ckpt_root", str(root),
                     "--save_path", "served", "--device", "cpu", "--users",
                     "0"] + flag)
    assert e.value.code == 2
