"""The port's ring backend against the JAX package on the CPU: the ring
partitions (byte-equal), the bucket plans, the ring hop (K6's plain
version) and its gradient, the ring model's encode for every edge norm,
one ring training step against JAX's mesh trainer, the meshes, the
Trainer and CLI over a mesh, and the checkpoint a ring run writes.

The JAX side runs on a 2 x 4 mesh of the 8 forced CPU devices
(tests/conftest.py), its Pallas ring kernel in interpret mode, jitted; the
port runs on a mesh of four CPU ranks (`make_mesh(model=4,
devices=["cpu"] * 4)`), where each bucket takes K6's plain version.
Tolerances: a ring hop rtol 1e-5 and atol 1e-5·sqrt(max degree), as
JAX's own ring tests hold it; the encode rtol 1e-4, atol 1e-5; a step's
losses rtol 1e-5 and its gradients rtol 1e-4 with atol 1e-6 x the largest
|g| over all parameters, as tests/test_torch_train.py holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagnn_tpu.config import Config as JConfig
from sagnn_tpu.config import ModelConfig as JModelConfig
from sagnn_tpu.config import TrainConfig as JTrainConfig
from sagnn_tpu.data.graph import compile_interval_graphs as j_compile
from sagnn_tpu.data.graph import edge_weights as j_edge_weights
from sagnn_tpu.data.synthetic import synthetic_dataset as j_synthetic
from sagnn_tpu.models.selfgnn import SelfGNN as JSelfGNN
from sagnn_tpu.models.selfgnn import TrainBatch as JTrainBatch
from sagnn_tpu.models.selfgnn import reg_loss as j_reg_loss
from sagnn_tpu.parallel import edge_partition as jep
from sagnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from sagnn_tpu.train.trainer import Trainer as JTrainer
from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch.convert import flatten_tree, params_from_numpy
from sagnn_tpu_torch.data.graph import compile_interval_graphs, edge_weights
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.models import selfgnn as tmodel
from sagnn_tpu_torch.models.selfgnn import SelfGNN, reg_loss
from sagnn_tpu_torch.parallel import edge_partition as ep
from sagnn_tpu_torch.parallel.mesh import make_mesh
from sagnn_tpu_torch.train.trainer import Trainer

from tests.torch_port_helpers import numpy_tree
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

P = 4
U, I, D, E = 120, 100, 16, 1500


def _mesh():
    return make_mesh(model=P, devices=["cpu"] * P)


def _j_mesh():
    return j_make_mesh(data=2, model=P)


def _graph(seed=0, weighted=False):
    """A target-sorted U-target COO over I sources with pad edges, its
    transpose, and (weighted) positive per-edge weights, the same value
    for an edge in both directions (symmetric, as sym_sqrt's)."""
    rng = np.random.default_rng(seed)
    tgt = np.sort(rng.integers(0, U, E)).astype(np.int32)
    src = rng.integers(0, I, E).astype(np.int32)
    w = (rng.random(E) + 0.25).astype(np.float32) if weighted else None
    o = np.argsort(src, kind="stable")
    pad_s, pad_t = np.zeros(7, np.int32), np.full(7, U, np.int32)
    return (np.concatenate([src, pad_s]), np.concatenate([tgt, pad_t]), w,
            tgt[o], src[o], None if w is None else w[o])


def _assert_parts_equal(got, want):
    for f in ("src_local", "tgt_local", "weights"):
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("rows_per_shard", "src_rows_per_shard", "num_tgt", "num_src"):
        assert getattr(got, f) == getattr(want, f), f


# -- host side ------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_partition_edges_ring_matches_jax(weighted):
    src, tgt, w, _, _, _ = _graph(1, weighted)
    if w is not None:
        w = np.concatenate([w, np.ones(7, np.float32)])
    got = ep.partition_edges_ring(src, tgt, I, U, P, weights=w)
    want = jep.partition_edges_ring(src, tgt, I, U, P, weights=w)
    _assert_parts_equal(got, want)
    # the model's blocks are JAX's padded table, split per rank
    x = np.random.default_rng(2).standard_normal((I, D)).astype(np.float32)
    blocks = ep.shard(torch.from_numpy(x), got.src_rows_per_shard, _mesh())
    assert [tuple(b.shape) for b in blocks] == [(got.src_rows_per_shard,
                                                  D)] * P
    np.testing.assert_array_equal(
        torch.cat(blocks).numpy(),
        jep.pad_node_table_rows(x, P, want.src_rows_per_shard))
    np.testing.assert_array_equal(ep.unshard(blocks, I, "cpu").numpy(), x)


@pytest.mark.parametrize("norm", [None, "sym_sqrt", "mean"])
def test_build_interval_ring_partitions_matches_jax(norm):
    kw = dict(num_users=48, num_items=64, graph_num=2, seed=21)
    jgb = j_compile(j_synthetic(**kw).sub_mats, pad_multiple=8)
    tb = synthetic_dataset(**kw)
    tgb = compile_interval_graphs(tb.sub_mats, pad_multiple=8)
    jw = tw = None
    if norm is not None:
        jw = j_edge_weights(jgb, j_synthetic(**kw).sub_mats, norm=norm)
        tw = edge_weights(tgb, tb.sub_mats, norm)
        np.testing.assert_array_equal(tw, jw)
    got = ep.build_interval_ring_partitions(tgb, P, pad_multiple=8,
                                            weights=tw)
    want = jep.build_interval_ring_partitions(jgb, P, pad_multiple=8,
                                              weights=jw)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def test_bucket_plans_hold_every_bucket_in_target_order():
    src, tgt, _, _, _, _ = _graph(3)
    parts = ep.partition_edges_ring(src, tgt, I, U, P)
    rows = parts.rows_per_shard
    ptr = ep.plan_ring_buckets(parts.src_local, parts.tgt_local, rows,
                               parts.src_rows_per_shard)
    assert ptr.shape == (P, P, rows + 1) and ptr.dtype == np.int32
    total = 0
    for p in range(P):
        for q in range(P):
            tl = parts.tgt_local[p, q]
            n = int((tl < rows).sum())
            assert ptr[p, q, 0] == 0 and ptr[p, q, -1] == n
            np.testing.assert_array_equal(
                np.repeat(np.arange(rows), np.diff(ptr[p, q])), tl[:n])
            total += n
    assert total == E
    bad = parts.src_local.copy()
    bad[1, 2, 0] = parts.src_rows_per_shard
    with pytest.raises(ValueError, match="outside its shard"):
        ep.plan_ring_buckets(bad, parts.tgt_local, rows,
                             parts.src_rows_per_shard)


# -- the ring hop (K6's plain version) and its gradient ---------------------------------

def _seg_atol(tgt, n_tgt):
    deg = np.bincount(np.asarray(tgt)[np.asarray(tgt) < n_tgt],
                      minlength=n_tgt)
    return 1e-5 * np.sqrt(max(1, int(deg.max())))


@pytest.mark.parametrize("weighted", [False, True])
def test_ring_hop_and_grad_match_jax(weighted):
    """The port's ring hop (`ring_spmm`, each bucket on K6's plain version)
    against JAX's `ring_spmm_pallas` (its Pallas kernel in interpret
    mode) and `ring_spmm_arrays`; its gradient (the ring over the
    transpose plan) against JAX's custom VJP."""
    src, tgt, w, bsrc, btgt, bw = _graph(4, weighted)
    fparts = jep.partition_edges_ring(src, tgt, I, U, P, weights=w)
    bparts = jep.partition_edges_ring(bsrc, btgt, U, I, P, weights=bw)
    rows, srows = fparts.rows_per_shard, fparts.src_rows_per_shard
    rng = np.random.default_rng(5)
    x = jep.pad_node_table_rows(
        rng.standard_normal((I, D)).astype(np.float32), P, srows)
    g = rng.standard_normal((P * rows, D)).astype(np.float32)
    g[U:] = 0.0                              # pad rows carry no cotangent

    fplan = jep.build_ring_bucket_plans(fparts)
    bplan = jep.build_ring_bucket_plans(bparts)
    nbf, nbb = fplan.pop("num_blocks"), bplan.pop("num_blocks")
    keys = ["src", "tgt_local", "chunk_block", "chunk_first"]
    keys += ["weights"] if weighted else []
    fa = tuple(jnp.asarray(fplan[k]) for k in keys)
    ba = tuple(jnp.asarray(bplan[k]) for k in keys)
    mesh = _j_mesh()

    def hop(x_):
        return jep.ring_spmm_pallas(mesh, x_, fa, ba, rows, nbf,
                                    bparts.rows_per_shard, nbb, "model")

    @jax.jit
    def fwd_vjp(x_, g_):
        out, vjp = jax.vjp(hop, x_)
        return out, vjp(g_)[0]

    with mesh:
        j_out, j_dx = fwd_vjp(jnp.asarray(x), jnp.asarray(g))
        j_arrays = jep.ring_edge_partitioned_spmm(mesh, jnp.asarray(x),
                                                  fparts)
    j_out, j_dx, j_arrays = map(np.asarray, (j_out, j_dx, j_arrays))

    tmesh = _mesh()
    tf = ep.partition_edges_ring(src, tgt, I, U, P, weights=w)
    tb = ep.partition_edges_ring(bsrc, btgt, U, I, P, weights=bw)
    plans = [ep.ring_plan(p.src_local[None], p.tgt_local[None],
                          p.rows_per_shard, p.src_rows_per_shard, tmesh,
                          None if p.weights is None else p.weights[None])
             for p in (tf, tb)]
    blocks = [b.requires_grad_() for b in
              ep.shard(torch.from_numpy(x), srows, tmesh)]
    out = ep.ring_spmm(blocks, plans[0], plans[1], 0, tmesh)
    dx = torch.autograd.grad(out, blocks,
                             ep.shard(torch.from_numpy(g), rows, tmesh))
    got = torch.cat(out).detach().numpy()
    atol = _seg_atol(tgt, U)
    np.testing.assert_allclose(got, j_out, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got, j_arrays, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(torch.cat(dx).numpy(), j_dx, rtol=1e-5,
                               atol=_seg_atol(btgt, I))
    assert not got[U:].any()                 # pad rows stay zero
    # the plain ring (the path 'mean' takes) in the same order: JAX's
    # ring_spmm_arrays, and on the CPU the very sums ring_spmm made
    plain = ep.unshard(ep.ring_spmm_apply_plain(
        ep.shard(torch.from_numpy(x), srows, tmesh), plans[0], 0, tmesh),
        P * rows, "cpu").numpy()
    np.testing.assert_array_equal(plain, got)
    np.testing.assert_allclose(plain, j_arrays, rtol=1e-5, atol=atol)


def test_exchange_copies_each_block():
    """A ring step always moves data: the receiver gets a new buffer with
    the block's values, even on the same device."""
    x = torch.randn(8, 4)
    got, ready = ep.exchange(x, torch.device("cpu"))
    assert ready is None and torch.equal(got, x)
    assert got.data_ptr() != x.data_ptr()


# -- the ring model ---------------------------------------------------------------------

BASE = dict(graph_num=2, gnn_layer=2, att_layer=1, latdim=16, num_heads=4,
            ssldim=8, pos_length=10, keep_rate=1.0)


def _jax_ring_graphs(gb, sub_mats, norm):
    """graphs["ring"] as JAX's Trainer attaches it (trainer.py:234-257):
    the Pallas ring's bucket plans for None/sym_sqrt, the XLA ring's
    arrays for 'mean'."""
    w = None if norm is None else j_edge_weights(gb, sub_mats, norm=norm)
    pallas_ring = norm in (None, "sym_sqrt")
    ring = jep.build_interval_ring_partitions(gb, P, weights=w,
                                              bucket_plans=pallas_ring)
    if pallas_ring:
        return {d: {k: jnp.asarray(v) for k, v in ring[d].items()
                    if k != "num_blocks"} for d in ("u_plan", "i_plan")}
    keys = ["u_src_local", "u_tgt_local", "i_src_local", "i_tgt_local"]
    keys += ["u_weights", "i_weights"]
    return {k: jnp.asarray(ring[k]) for k in keys}


@pytest.mark.parametrize("norm", [None, "sym_sqrt", "mean"])
def test_ring_encode_matches_jax_ring_backend(norm):
    """The ring model's encode (through `SelfGNN.encode`) against JAX's
    ring backend on the same weights; the pad rows never leak into the
    true rows."""
    kw = dict(num_users=48, num_items=64, graph_num=2, seed=21)
    jb = j_synthetic(**kw)
    jgb = j_compile(jb.sub_mats, pad_multiple=8)
    jcfg = JModelConfig(**BASE, spmm_backend="ring", edge_norm=norm)
    mesh = _j_mesh()
    jm = JSelfGNN(jcfg, 48, 64, mesh=mesh)
    jp = jm.init(jax.random.PRNGKey(7))
    jg = {"ring": _jax_ring_graphs(jgb, jb.sub_mats, norm)}
    with mesh:
        jfu, jfi, juv, jiv = jax.jit(
            lambda p: jm.encode(p, jg, train=False))(jp)

    tb = synthetic_dataset(**kw)
    tgb = compile_interval_graphs(tb.sub_mats, pad_multiple=8)
    tmesh = _mesh()
    graphs = {"ring": ep.ring_graphs(
        tgb, tmesh, None if norm is None else edge_weights(tgb, tb.sub_mats,
                                                           norm))}
    tm = SelfGNN(tcfg.ModelConfig(**BASE, spmm_backend="ring",
                                  edge_norm=norm), 48, 64, mesh=tmesh)
    got = tm.encode(params_from_numpy(numpy_tree(jp)), graphs)
    for a, b in zip(got, (jfu, jfi, juv, jiv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=str(norm))


def _trainer_cfg(backend="ring", **model):
    return tcfg.Config(
        model=tcfg.ModelConfig(**BASE, spmm_backend=backend, **model),
        train=tcfg.TrainConfig(batch=16, samp_num=4, ssl_num=2, trn_num=32,
                               test_size=10, lr=5e-3, reg=1e-2,
                               ssl_reg=1e-3, epoch=1, tst_epoch=1,
                               save_path="ring"))


def test_ring_train_step_matches_jax_mesh_trainer(tmp_path):
    """One keep_rate-1 step's losses and gradients: the port's Trainer over
    a four-rank CPU mesh against JAX's Trainer over its 2 x 4 mesh, with
    JAX's parameters carried across by convert.py and one batch."""
    kw = dict(num_users=48, num_items=64, graph_num=2, test_size=10, seed=2)
    cfg = _trainer_cfg()
    jcfg = JConfig(model=JModelConfig(**dataclasses.asdict(cfg.model)),
                   train=JTrainConfig(**dataclasses.asdict(cfg.train)))
    mesh = _j_mesh()
    jtr = JTrainer(jcfg, j_synthetic(**kw), ckpt_root=str(tmp_path / "j"),
                   mesh=mesh)
    tr = Trainer(cfg, synthetic_dataset(**kw), ckpt_root=str(tmp_path / "t"),
                 mesh=_mesh())
    batch = tr.sampler.train_batch(tr.sampler.epoch_user_ids(32)[:16])
    jbatch = JTrainBatch(*(jnp.asarray(getattr(batch, f.name))
                           for f in dataclasses.fields(JTrainBatch)))
    tc = cfg.train

    def j_loss(p):
        pre, ssl, _ = jtr.model.train_losses(p, jtr.graphs, jbatch)
        return pre + tc.reg * j_reg_loss(p) + tc.ssl_reg * ssl, (pre, ssl)

    with mesh:
        (_, (j_pre, j_ssl)), j_grads = jax.jit(jax.value_and_grad(
            j_loss, has_aux=True))(jtr.state["params"])
    params = {k: v.requires_grad_() for k, v in
              params_from_numpy(numpy_tree(jtr.state["params"])).items()}
    pre, ssl, _ = tr.model.train_losses(params, tr.graphs, batch.to("cpu"))
    loss = pre + tc.reg * reg_loss(params) + tc.ssl_reg * ssl
    keys = sorted(params)
    grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                allow_unused=True)
    np.testing.assert_allclose(pre.item(), float(j_pre), rtol=1e-5)
    np.testing.assert_allclose(ssl.item(), float(j_ssl), rtol=1e-5)
    want = flatten_tree(numpy_tree(j_grads))
    g_max = max(np.abs(v).max() for v in want.values())
    for k, g in zip(keys, grads):
        got = np.zeros_like(want[k]) if g is None else g.numpy()
        np.testing.assert_allclose(got, want[k], rtol=1e-4,
                                   atol=1e-6 * g_max, err_msg=k)


def test_ring_remat_changes_no_loss_or_gradient(tmp_path):
    """remat_propagation on the ring: each interval under a checkpoint (as
    JAX checkpoints its scan body), whose recompute repeats the ring."""
    bundle = synthetic_dataset(num_users=48, num_items=64, graph_num=2,
                               test_size=10, seed=2)
    tr = Trainer(_trainer_cfg(), bundle, ckpt_root=str(tmp_path),
                 mesh=_mesh())
    batch = tr.sampler.train_batch(tr.sampler.epoch_user_ids(32)[:16])
    out = []
    for remat in (False, True):
        model = SelfGNN(dataclasses.replace(tr.cfg.model,
                                            remat_propagation=remat),
                        48, 64, mesh=tr.mesh)
        p = {k: v.detach().clone().requires_grad_()
             for k, v in tr.state["params"].items()}
        pre, ssl, _ = model.train_losses(p, tr.graphs, batch.to("cpu"))
        keys = sorted(p)
        grads = torch.autograd.grad(pre + 1e-3 * ssl, [p[k] for k in keys],
                                    allow_unused=True)
        out.append((pre, ssl, dict(zip(keys, grads))))
    (pre, ssl, grads), (rpre, rssl, rgrads) = out
    torch.testing.assert_close(rpre, pre, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(rssl, ssl, rtol=1e-6, atol=0.0)
    for k, g in grads.items():
        if g is None:
            assert rgrads[k] is None, k
        else:
            torch.testing.assert_close(rgrads[k], g, rtol=1e-5, atol=1e-7,
                                       msg=k)


# -- refusals and meshes ----------------------------------------------------------------

def test_check_ported_keeps_jax_ring_refusals():
    ring = tcfg.ModelConfig(spmm_backend="ring", edge_dropout_keep=0.8)
    tmodel.check_ported(ring)                # serving draws no edge mask
    with pytest.raises(ValueError, match="bucketed"):
        tmodel.check_ported(ring, train=True)
    with pytest.raises(ValueError, match="pallas"):
        tmodel.check_ported(dataclasses.replace(
            ring, edge_dropout_keep=1.0, edge_attention=True))
    with pytest.raises(ValueError, match="mesh"):
        SelfGNN(dataclasses.replace(ring, edge_dropout_keep=1.0), 4, 4)


def test_trainer_mesh_refusals(tmp_path):
    bundle = synthetic_dataset(num_users=48, num_items=64, graph_num=2,
                               test_size=10, seed=2)
    with pytest.raises(ValueError, match="requires a mesh"):
        Trainer(_trainer_cfg(), bundle, ckpt_root=str(tmp_path),
                device="cpu")
    # a mesh with a data axis and a mesh on "pallas" train now, with every
    # option (tests/test_torch_trainer_mesh.py, ROADMAP A6(e)); edge
    # attention off "pallas" raises as JAX asserts
    Trainer(_trainer_cfg("pallas", edge_attention=True), bundle,
            ckpt_root=str(tmp_path),
            mesh=make_mesh(data=2, model=2, devices=["cpu"] * 4))
    Trainer(_trainer_cfg("pallas", remat_propagation=True), bundle,
            ckpt_root=str(tmp_path), mesh=_mesh())
    with pytest.raises(ValueError, match="requires spmm_backend='pallas'"):
        Trainer(_trainer_cfg(edge_attention=True), bundle,
                ckpt_root=str(tmp_path), mesh=_mesh())
    with pytest.raises(ValueError, match="bucketed"):
        Trainer(_trainer_cfg(edge_dropout_keep=0.8), bundle,
                ckpt_root=str(tmp_path), mesh=_mesh())


def test_make_mesh_needs_the_devices_it_names():
    """Without devices= the mesh is the visible cards (none here): a size
    that is not their count fails, as JAX's make_mesh does, and nothing
    falls back to the CPU."""
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="devices"):
        make_mesh(data=1, model=n + 4)
    with pytest.raises(ValueError, match="devices"):
        make_mesh(data=3, model=2, devices=["cpu"] * 4)
    mesh = make_mesh(model=2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.model_devices == [torch.device("cpu")] * 2


# -- entry points -------------------------------------------------------------------------

@pytest.mark.parametrize("norm", [None, "mean"])
def test_ring_trainer_trains_evaluates_and_restores_into_pallas(tmp_path,
                                                                norm):
    """As JAX's test_mesh_trainer_ring_backend: the ring Trainer's loss
    falls and it evaluates through the ring; its checkpoint (the
    single-device format) restores into a "pallas" Trainer bit for bit,
    which evaluates alike."""
    bundle = synthetic_dataset(num_users=48, num_items=64, graph_num=2,
                               test_size=10, seed=2)
    cfg = _trainer_cfg(edge_norm=norm)
    if norm == "mean":
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, lr=2e-2))
    tr = Trainer(cfg, bundle, ckpt_root=str(tmp_path), mesh=_mesh())
    assert set(tr.graphs) == {"ring"}       # no COO blocks ride along
    first = tr.train_epoch(verbose=False)
    for _ in range(3):
        last = tr.train_epoch(verbose=False)
    assert last["preLoss"] < first["preLoss"]
    mets = tr.test_epoch()
    tr.ckpt.save(tr.state, tr.history, tr.cfg,
                 rng_state=tr.capture_rng_state(4))

    pallas = cfg.replace(
        model=dataclasses.replace(cfg.model, spmm_backend="pallas"),
        train=dataclasses.replace(cfg.train, load_model="ring"))
    back = Trainer(pallas, bundle, ckpt_root=str(tmp_path), device="cpu")
    assert back.restore_checkpoint() == 4
    assert back.state["step"] == tr.state["step"]
    for k, v in tr.state["params"].items():
        assert torch.equal(back.state["params"][k], v), k
    for k, v in back.test_epoch().items():
        assert v == pytest.approx(mets[k], abs=1e-6), k


def test_cli_trains_on_the_ring(tmp_path, capsys):
    from sagnn_tpu_torch import main as cli
    cli.main(["--data", "synthetic", "--device", "cpu", "--synth_users",
              "48", "--synth_items", "64", "--graphNum", "2", "--epoch", "1",
              "--trnNum", "32", "--batch", "16", "--testSize", "8",
              "--sslNum", "2", "--sampNum", "4", "--latdim", "16",
              "--num_attention_heads", "4", "--ssldim", "8", "--pos_length",
              "10", "--att_layer", "1", "--tstEpoch", "1", "--spmm_backend",
              "ring", "--mesh_model", "4", "--edge_norm", "sym_sqrt",
              "--ckpt_root", str(tmp_path), "--save_path", "ring"])
    out = capsys.readouterr().out
    assert "Mesh: data=1 model=4" in out
    assert "Epoch 0/1, Train: Loss = " in out and ", max: " in out


def test_recommender_serves_a_ring_config_on_xla():
    """The ring is a training layout: its config serves on one device from
    the same weights (scripts/recommend.py:67-73), on the "pallas" backend
    so that the card runs the segment-sum kernel; its encode is the "xla"
    backend's, the JAX script's choice, within f32 rounding."""
    from sagnn_tpu_torch.serve import Recommender
    bundle = synthetic_dataset(num_users=48, num_items=64, graph_num=2,
                               test_size=10, seed=2)
    cfg = _trainer_cfg()
    rec = Recommender(cfg, bundle, device="cpu")
    assert rec.cfg.model.spmm_backend == "pallas"
    for backend in ("pallas", "xla"):
        other = Recommender(cfg.replace(model=dataclasses.replace(
            cfg.model, spmm_backend=backend)), bundle, rec.params,
            device="cpu")
        for a, b in zip(rec.encode(), other.encode()):
            if backend == "pallas":
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
