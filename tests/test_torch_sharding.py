"""The port's sharding rules and its step over a data x model mesh of CPU
ranks (`sagnn_tpu_torch/parallel/sharding.py`, `parallel/distributed.py`,
`SelfGNN.encode_sharded`) against the JAX package at
tests/test_parallel.py's size (g 2, gnn_layer 1, latdim 16, 64 users x 96
items, batch 16).

JAX's side is its single-device step (`make_train_step`'s loss and
`jax.grad` of it), not its GSPMD step, which JAX's own test marks slow.
Tolerances are tests/test_torch_train.py's: losses rtol 1e-5, gradients
rtol 1e-4 and atol 1e-6 x the largest |g|; against the port's own
single-device step the same. Every mesh names its ranks on the CPU
(`make_mesh(devices=["cpu"] * n)`), where the kernels' wrappers run their
plain versions.
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
from sagnn_tpu.data.sampler import Sampler as JSampler
from sagnn_tpu.data.synthetic import synthetic_dataset as j_synthetic
from sagnn_tpu.models.selfgnn import SelfGNN as JSelfGNN
from sagnn_tpu.models.selfgnn import reg_loss as j_reg_loss
from sagnn_tpu.train.trainer import graphs_to_device as j_graphs
from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch.convert import flatten_tree, params_from_numpy
from sagnn_tpu_torch.data.graph import compile_interval_graphs
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.models.selfgnn import (TrainBatch, graphs_to_device,
                                            reg_loss)
from sagnn_tpu_torch.ops import spmm_cuda as sc
from sagnn_tpu_torch.parallel import sharding as shd
from sagnn_tpu_torch.parallel.distributed import shard_inputs
from sagnn_tpu_torch.parallel.launch import global_mesh
from sagnn_tpu_torch.parallel.mesh import make_mesh
from sagnn_tpu_torch.train.optim import AdamState
from sagnn_tpu_torch.train.trainer import Trainer

from tests.torch_port_helpers import numpy_tree
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

MODEL = dict(graph_num=2, gnn_layer=1, att_layer=1, latdim=16, num_heads=4,
             ssldim=8, pos_length=16, keep_rate=1.0)
TRAIN = dict(batch=16, samp_num=4, ssl_num=2, trn_num=32, test_size=10,
             reg=1e-2, ssl_reg=1e-3)
SHAPES = [(2, 1), (1, 2), (2, 2), (4, 2)]


def cpu_mesh(data, model):
    return make_mesh(data=data, model=model, devices=["cpu"] * (data * model))


def port_cfg(backend="pallas", **model):
    return tcfg.Config(model=tcfg.ModelConfig(**{**MODEL, **model},
                                              spmm_backend=backend),
                       train=tcfg.TrainConfig(**TRAIN))


def close(got, want, what, rtol=1e-5):
    def f(x):
        return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)

    np.testing.assert_allclose(f(got), f(want), rtol=rtol, err_msg=what)


def grads_close(got, want, scale=None):
    """Every gradient within rtol 1e-4, atol 1e-6 x the largest |g|."""
    scale = scale or max(float(np.abs(np.asarray(v)).max())
                         for v in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w),
                                   rtol=1e-4, atol=1e-6 * scale, err_msg=k)


@pytest.fixture(scope="module")
def env():
    """JAX's bundle, weights, batch and single-device losses and gradients
    (test_parallel.py's setup), and the port's bundle, weights and batch."""
    jcfg = JConfig(model=JModelConfig(**MODEL), train=JTrainConfig(**TRAIN))
    jb = j_synthetic(num_users=64, num_items=96, graph_num=2, test_size=10,
                     seed=1)
    jm = JSelfGNN(jcfg.model, jb.num_users, jb.num_items)
    jg = j_graphs(j_compile(jb.sub_mats, pad_multiple=64))
    sampler = JSampler(bundle=jb, batch=16, samp_num=4, ssl_num=2,
                       pred_num=5, pos_length=16, test_size=10, seed=3,
                       backend="numpy")
    jbatch = sampler.train_batch(sampler.epoch_user_ids(16))
    jp = jm.init(jax.random.PRNGKey(0))

    def loss_fn(p):
        pre, ssl, _ = jm.train_losses(p, jg, jbatch, None)
        return (pre + TRAIN["reg"] * j_reg_loss(p)
                + TRAIN["ssl_reg"] * ssl), pre

    (loss, pre), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                    has_aux=True))(jp)
    batch = TrainBatch(*(np.array(getattr(jbatch, f.name))
                         for f in dataclasses.fields(TrainBatch)))
    bundle = synthetic_dataset(num_users=64, num_items=96, graph_num=2,
                               test_size=10, seed=1)
    return {"params": params_from_numpy(numpy_tree(jp)), "batch": batch,
            "bundle": bundle, "loss": float(loss), "pre": float(pre),
            "grads": flatten_tree(numpy_tree(grads))}


def mesh_trainer(env, shape, tmp_path, backend="pallas", **model):
    tr = Trainer(port_cfg(backend, **model), env["bundle"],
                 ckpt_root=str(tmp_path), mesh=cpu_mesh(*shape))
    tr.load_imported_params(env["params"])
    return tr


def whole_grads(tr, grads):
    """The summed gradients, data rank 0's shards laid end to end."""
    specs = tr.mesh_state.specs
    return {k: shd.gather(v, specs[k], torch.device("cpu")).numpy()
            for k, v in grads.items()}


# -- rules and placement ---------------------------------------------------------

def test_make_mesh_shapes():
    m = make_mesh(data=4, model=2, devices=["cpu"] * 8)
    assert m.shape == {"data": 4, "model": 2}
    assert make_mesh(model=2, devices=["cpu"] * 8).shape == m.shape
    assert make_mesh(devices=["cpu"] * 8).shape == {"data": 8, "model": 1}
    assert m.row(3).shape == {"data": 1, "model": 2}
    # without a process group the global mesh is this process's
    g = global_mesh(model=2, devices=["cpu"] * 4)
    assert g.shape == {"data": 2, "model": 2} and g.data_offset == 0


def test_param_shardings_cover_tables(env):
    mesh = cpu_mesh(4, 2)
    rules = shd.ShardingRules(mesh)
    sh = shd.param_shardings(rules, env["params"])
    assert sh["reg/u_embed"] == (None, "model", None)
    assert sh["reg/i_embed"] == (None, "model", None)
    assert sh["reg/meta2_w"] == () and sh["free/lstm/kernel"] == ()
    assert set(shd.param_shardings(rules, env["params"],
                                   split_tables=False).values()) == {()}
    opt = shd.opt_state_shardings(
        rules, AdamState(mu=dict(env["params"]), nu=dict(env["params"])), sh)
    assert opt.mu == sh and opt.nu == sh and opt.count == ()
    bs = shd.batch_shardings(rules, env["batch"])
    assert bs.uids == ("data",) and bs.seq == ("data",)
    assert bs.ssl_u_a == (None, "data")
    # placed: every data rank holds the model row, the tables' rows split
    u = env["params"]["reg/u_embed"]
    rows = shd.place(u, sh["reg/u_embed"], mesh)
    assert len(rows) == 4 and all(len(r) == 2 for r in rows)
    assert [r.shape[1] for r in rows[0]] == [32, 32]
    for r in rows:
        assert torch.equal(shd.gather(r, sh["reg/u_embed"],
                                      torch.device("cpu")), u)
    assert shd.row_bounds(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert shd.graph_shardings(rules, {"u_src": 0, "ring": 0}) == {
        "u_src": (), "ring": ("model",)}


def test_shard_inputs_localises_sequence_rows(env):
    """Each data rank's pairs read their users' sequences from its own
    rows: seq[useq_row] of every real pair is the whole batch's."""
    batch = env["batch"]
    sb = shard_inputs(shd.ShardingRules(cpu_mesh(4, 1)), batch)
    assert sb.pairs == float(batch.pair_mask.sum())
    per = len(batch.uids) // 4
    for d, part in enumerate(sb.parts):
        real = part.pair_mask.numpy() > 0
        want = batch.seq[batch.useq_row[d * per:(d + 1) * per]]
        got = part.seq.numpy()[part.useq_row.numpy()]
        np.testing.assert_array_equal(got[real], want[real])
        assert part.ssl_u_a.shape == (2, batch.ssl_u_a.shape[1] // 4)


@pytest.mark.parametrize("weighted", [False, True])
def test_tp_hop_matches_the_whole_hop(env, weighted):
    """A hop cut over 3 model ranks (the last one short) and its gradient
    equal the unsharded hop's (`spmm`, `spmm_weighted`)."""
    mc = port_cfg(edge_norm="sym_sqrt" if weighted else None).model
    bundle = env["bundle"]
    g = graphs_to_device(compile_interval_graphs(bundle.sub_mats), "cpu",
                         mc, bundle.sub_mats)
    dev = torch.device("cpu")
    tp = shd.tp_graphs({dev: g}, [dev] * 3, bundle.num_users,
                       bundle.num_items)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((96, 16)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    w = g["edge_weights"][0][0] if weighted else None
    xs = [x[lo:hi].clone().requires_grad_() for lo, hi in tp.item_rows]
    if weighted:
        hop = tp.weighted_hop("u", 0, True)
        out = torch.cat(shd.tp_weighted_spmm(
            xs, [w[e0:e1] for e0, e1 in hop.cuts], hop))
    else:
        out = torch.cat(shd.tp_spmm(xs, tp.hop("u", 0, True)))
    dx = torch.cat(torch.autograd.grad(out, xs, cot))
    xw = x.clone().requires_grad_()
    if weighted:
        want = sc.spmm_weighted(xw, w, g["u_src"][0], g["u_tgt"][0],
                                g["u_ptr"][0], g["i_src"][0], g["i_ptr"][0],
                                g["i_from_u"][0])
    else:
        want = sc.spmm(xw, g["u_src"][0], g["u_ptr"][0], g["i_src"][0],
                       g["i_ptr"][0])
    dwant, = torch.autograd.grad(want, xw, cot)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dx, dwant, rtol=1e-6, atol=1e-6)


# -- the step against JAX's single-device step ----------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_step_matches_jax_single_device(env, tmp_path, shape,
                                                backend):
    tr = mesh_trainer(env, shape, tmp_path, backend)
    totals, grads = tr._mesh_step.loss_and_grads(tr.mesh_state,
                                                 env["batch"])
    close(totals["loss"], env["loss"], "loss")
    close(totals["preLoss"], env["pre"], "preLoss")
    grads_close(whole_grads(tr, grads), env["grads"])


def single_device_step(env, tmp_path, backend, gen_state=None, **model):
    """The port's single-device step on env's weights and batch: (loss,
    preLoss, gradients as numpy), its masks drawn from `gen_state` (a
    Trainer's dropout generator state) when given."""
    one = Trainer(port_cfg(backend, **model), env["bundle"],
                  ckpt_root=str(tmp_path), device="cpu")
    one.load_imported_params(env["params"])
    if gen_state is not None:
        one.dropout_gen.set_state(gen_state)
    params = one.state["params"]
    pre, ssl, _ = one.model.train_losses(params, one.graphs,
                                         env["batch"].to("cpu"),
                                         one.dropout_gen)
    loss = pre + TRAIN["reg"] * reg_loss(params) + TRAIN["ssl_reg"] * ssl
    keys = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                allow_unused=True)
    return loss, pre, {k: np.zeros(tuple(params[k].shape), np.float32)
                       if g is None else g.numpy()
                       for k, g in zip(keys, grads)}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_mesh_step_matches_single_device_at_keep_rate_half(env, tmp_path,
                                                           backend):
    """At keepRate 0.5 (and with edge dropout on "xla") a 2 x 2 mesh step
    draws the single-device step's masks from the same generator state,
    so its losses and gradients are the single-device port's."""
    extra = {"keep_rate": 0.5}
    if backend == "xla":
        extra["edge_dropout_keep"] = 0.8
    tr = mesh_trainer(env, (2, 2), tmp_path / "m", backend, **extra)
    state = tr.dropout_gen.get_state()
    totals, grads = tr._mesh_step.loss_and_grads(
        tr.mesh_state, env["batch"], tr.dropout_gen)
    loss, pre, want = single_device_step(env, tmp_path / "s", backend,
                                         state, **extra)
    close(totals["loss"], loss, "loss")
    close(totals["preLoss"], pre, "preLoss")
    grads_close(whole_grads(tr, grads), want)


@pytest.mark.parametrize("option", [
    {"edge_attention": True}, {"spmm_src_shard_rows": 16}, {"remat_propagation": True},
    {"fusion_chunk_rows": 8}, {"fusion_dtype": "bf16"}])
@pytest.mark.parametrize("shape", [(1, 1), (2, 1)])
def test_data_parallel_mesh_takes_every_option(env, tmp_path, shape,
                                               option):
    """A mesh of one model rank runs each data rank's single-device encode,
    so it takes the options a tensor-parallel mesh refuses (ROADMAP
    A6(e)), and its step is the single-device port's: losses and
    gradients at the module's tolerances, but for the bf16 stack on two
    data ranks, whose backwards each round their own share of the
    cotangents to bf16: there every gradient within rtol 1e-2 and one
    bf16 ulp (2^-7) of the largest |g| (measured 9e-4 of it). With edge
    attention the loss is not the step's without it (an encode that
    dropped the option)."""
    model = {"keep_rate": 0.5, **option}
    tr = mesh_trainer(env, shape, tmp_path / "m", "pallas", **model)
    state = tr.dropout_gen.get_state()
    totals, grads = tr._mesh_step.loss_and_grads(
        tr.mesh_state, env["batch"], tr.dropout_gen)
    loss, pre, want = single_device_step(env, tmp_path / "s", "pallas",
                                         state, **model)
    close(totals["loss"], loss, "loss")
    close(totals["preLoss"], pre, "preLoss")
    got = whole_grads(tr, grads)
    if option.get("fusion_dtype") == "bf16" and shape[0] > 1:
        g_max = max(float(np.abs(w).max()) for w in want.values())
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-2,
                                       atol=2.0 ** -7 * g_max, err_msg=k)
    else:
        grads_close(got, want)
    if "edge_attention" in option:
        plain, _, _ = single_device_step(env, tmp_path / "p", "pallas",
                                         state, keep_rate=0.5)
        plain, loss = float(plain.detach()), float(loss.detach())
        assert abs(plain - loss) > 1e-4 * abs(loss)


def test_replicas_are_bit_equal_after_a_step(env, tmp_path):
    """Every data rank applies the one update to the one summed gradient:
    params and moments bit-equal across the 4 x 2 mesh's replicas."""
    tr = mesh_trainer(env, (4, 2), tmp_path, keep_rate=0.5)
    for _ in range(2):
        tr.train_step(env["batch"])
    st = tr.mesh_state
    assert st.step == st.count == 2
    for part in (st.params, st.mu, st.nu):
        for row in part[1:]:
            for k, shards in row.items():
                for a, b in zip(shards, part[0][k]):
                    assert torch.equal(a, b), k
    assert not torch.equal(st.params[0]["reg/u_embed"][0],
                           env["params"]["reg/u_embed"][:, :32])


def test_short_batch_is_normalised_over_the_whole_batch(env, tmp_path):
    """A short last batch (5 users of 16): on a 4 x 1 mesh two data ranks
    hold only padding. preLoss divides the hinge sum by the whole batch's
    real pairs, as JAX's single-device step, not a mean of per-rank
    means."""
    jcfg = JConfig(model=JModelConfig(**MODEL), train=JTrainConfig(**TRAIN))
    jb = j_synthetic(num_users=64, num_items=96, graph_num=2, test_size=10,
                     seed=1)
    jm = JSelfGNN(jcfg.model, 64, 96)
    jg = j_graphs(j_compile(jb.sub_mats, pad_multiple=64))
    sampler = JSampler(bundle=jb, batch=16, samp_num=4, ssl_num=2,
                       pred_num=5, pos_length=16, test_size=10, seed=3,
                       backend="numpy")
    jbatch = sampler.train_batch(sampler.epoch_user_ids(16)[:5])
    jparams = jax.tree_util.tree_map(
        jnp.asarray, jm.init(jax.random.PRNGKey(0)))
    j_pre = float(jm.train_losses(jparams, jg, jbatch, None)[0])
    batch = TrainBatch(*(np.array(getattr(jbatch, f.name))
                         for f in dataclasses.fields(TrainBatch)))
    tr = mesh_trainer(env, (4, 1), tmp_path)
    sb = shard_inputs(tr._mesh_step.rules, batch)
    assert [float(p.pair_mask.sum()) > 0 for p in sb.parts] == [
        True, True, False, False]
    totals, _ = tr._mesh_step.loss_and_grads(tr.mesh_state, sb)
    close(totals["preLoss"], j_pre, "preLoss")


@pytest.mark.parametrize("shape", [(4, 2), (8, 1)])
def test_fold_gather_on_a_mesh_matches_jax(env, tmp_path, shape):
    """spmm_fold_gather (K4's plain version) on the tables split over
    'model': the encode equals JAX's single-device unfolded encode (JAX
    tests/test_parallel.py:186, rtol and atol 1e-5)."""
    jm = JSelfGNN(JModelConfig(**MODEL), 64, 96)
    jb = j_synthetic(num_users=64, num_items=96, graph_num=2, test_size=10,
                     seed=1)
    jg = j_graphs(j_compile(jb.sub_mats, pad_multiple=64))
    jp = jax.tree_util.tree_map(jnp.asarray, jm.init(jax.random.PRNGKey(0)))
    fu_ref, fi_ref, _, _ = jax.jit(lambda p, g: jm.encode(p, g))(jp, jg)
    tr = Trainer(port_cfg(spmm_fold_gather=True), env["bundle"],
                 ckpt_root=str(tmp_path), mesh=cpu_mesh(*shape))
    tr.load_imported_params(env["params"])
    with torch.no_grad():
        fu, fi, _, _ = tr._mesh_step.encode(tr.mesh_state, 0)
    np.testing.assert_allclose(fu.numpy(), np.asarray(fu_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(fi.numpy(), np.asarray(fi_ref), rtol=1e-5,
                               atol=1e-5)
