"""The options a tensor-parallel mesh takes since they were ported: edge
attention, source sharding (with the fold), remat_propagation,
fusion_chunk_rows and the bf16 stack, on meshes of CPU ranks whose node
tables are split over two model ranks (`parallel/sharding.py`,
`SelfGNN.encode_sharded`).

JAX's side is its GSPMD step on its 2 x 2 CPU mesh (tests/conftest.py):
the params laid out by its `param_shardings`, the graphs and the batch by
its `shard_inputs`, `jax.value_and_grad` of the training loss jitted
under the mesh, its Pallas calls in interpret mode (edge attention and
source sharding run JAX's "pallas" backend, the other three its "xla"
one, whose values they do not change). The configuration is
tests/test_parallel.py's at 48 users x 64 items (g 2, gnn_layer 1,
latdim 16, 4 heads, pos_length 16, batch 16). Tolerances are
tests/test_torch_sharding.py's: losses rtol 1e-5, gradients rtol 1e-4 and
atol 1e-6 x the largest |g|; the bf16 stack tests/test_torch_bf16.py's:
losses rtol 1e-2, gradients rtol 0.05 and atol 5e-2 x the largest |g|.
The tensor-parallel hops of K3 and of K5 -> edge softmax -> K2 are held
against the unsharded hops at 1e-6, forward and backward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagnn_tpu.config import ModelConfig as JModelConfig
from sagnn_tpu.data.graph import compile_interval_graphs as j_compile
from sagnn_tpu.data.graph import direction_permutation as j_perm
from sagnn_tpu.data.sampler import Sampler as JSampler
from sagnn_tpu.data.synthetic import synthetic_dataset as j_synthetic
from sagnn_tpu.models.selfgnn import SelfGNN as JSelfGNN
from sagnn_tpu.models.selfgnn import reg_loss as j_reg_loss
from sagnn_tpu.ops.spmm_pallas import build_stacked_plans as j_plans
from sagnn_tpu.ops.spmm_pallas import \
    build_stacked_plans_src_sharded as j_plans_ss
from sagnn_tpu.parallel.distributed import shard_inputs as j_shard_inputs
from sagnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from sagnn_tpu.parallel.sharding import ShardingRules as JRules
from sagnn_tpu.parallel.sharding import param_shardings as j_param_shardings
from sagnn_tpu.train.trainer import graphs_to_device as j_graphs
from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch.convert import flatten_tree, params_from_numpy
from sagnn_tpu_torch.data.graph import compile_interval_graphs
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.models.selfgnn import TrainBatch, graphs_to_device
from sagnn_tpu_torch.ops import spmm_cuda as sc
from sagnn_tpu_torch.ops.edge_attention import attention_propagate
from sagnn_tpu_torch.parallel import sharding as shd
from sagnn_tpu_torch.parallel.mesh import make_mesh
from sagnn_tpu_torch.train.trainer import Trainer

from tests.torch_port_helpers import numpy_tree
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

MODEL = dict(graph_num=2, gnn_layer=1, att_layer=1, latdim=16, num_heads=4,
             ssldim=8, pos_length=16, keep_rate=1.0)
TRAIN = dict(batch=16, samp_num=4, ssl_num=2, trn_num=32, test_size=10,
             reg=1e-2, ssl_reg=1e-3)
USERS, ITEMS = 48, 64
# JAX's backend for each option: its kernels where the option is a kernel
# path, its "xla" backend where the option only reorganises the work
OPTIONS = {
    "edge_attention": ({"edge_attention": True}, "pallas"),
    "spmm_src_shard_rows": ({"spmm_src_shard_rows": 16}, "pallas"),
    "remat_propagation": ({"remat_propagation": True}, "xla"),
    "fusion_chunk_rows": ({"fusion_chunk_rows": 8}, "xla"),
    "fusion_dtype": ({"fusion_dtype": "bf16"}, "xla"),
}


def cpu_mesh(data, model):
    return make_mesh(data=data, model=model, devices=["cpu"] * (data * model))


def port_cfg(backend="pallas", **model):
    return tcfg.Config(model=tcfg.ModelConfig(**{**MODEL, **model},
                                              spmm_backend=backend),
                       train=tcfg.TrainConfig(**TRAIN))


@pytest.fixture(scope="module")
def env():
    """JAX's bundle, compiled graphs, weights and batch, and the port's
    bundle, the same weights and batch."""
    jb = j_synthetic(num_users=USERS, num_items=ITEMS, graph_num=2,
                     test_size=10, seed=2)
    gb = j_compile(jb.sub_mats, pad_multiple=64)
    sampler = JSampler(bundle=jb, batch=16, samp_num=4, ssl_num=2,
                       pred_num=5, pos_length=16, test_size=10, seed=3,
                       backend="numpy")
    jbatch = sampler.train_batch(sampler.epoch_user_ids(16))
    jp = JSelfGNN(JModelConfig(**MODEL), USERS, ITEMS).init(
        jax.random.PRNGKey(0))
    return {"jbundle": jb, "gb": gb, "jbatch": jbatch, "jparams": jp,
            "params": params_from_numpy(numpy_tree(jp)),
            "batch": TrainBatch(*(np.array(getattr(jbatch, f.name))
                                  for f in dataclasses.fields(TrainBatch))),
            "bundle": synthetic_dataset(num_users=USERS, num_items=ITEMS,
                                        graph_num=2, test_size=10, seed=2)}


def jax_graphs(env, mc):
    """JAX's graphs for `mc` as its Trainer attaches them
    (sagnn_tpu/train/trainer.py:187-233): the tracked plans for edge
    attention, the source-sharded plans, the plain plans for "pallas"."""
    gb = env["gb"]
    graphs = j_graphs(gb)
    args = (gb.u_src, gb.u_tgt, gb.i_src, gb.i_tgt, gb.num_users,
            gb.num_items, gb.edge_counts)
    if mc.spmm_src_shard_rows > 0:
        ss = j_plans_ss(*args, shard_rows=mc.spmm_src_shard_rows)
        graphs["plans_ss"] = {d: {k: jnp.asarray(v) for k, v in
                                  ss[d].items()} for d in ("u", "i")}
    elif mc.spmm_backend == "pallas":
        tracked = mc.edge_attention
        plans = j_plans(*args, track_edges=tracked, i_edge_ids=j_perm(
            gb, env["jbundle"].sub_mats) if tracked else None)
        graphs["plans"] = {d: {k: jnp.asarray(v) for k, v in
                               plans[d].items()} for d in ("u", "i")}
    return graphs


def jax_sharded_step(env, mc, shape=(2, 2)):
    """(loss, preLoss, gradients keyed as the port's) of JAX's GSPMD step
    on a `shape` mesh of its CPU devices, without the update (JAX
    tests/test_parallel.py:58-99)."""
    mesh = j_make_mesh(data=shape[0], model=shape[1],
                       devices=jax.devices()[:shape[0] * shape[1]])
    rules = JRules(mesh)
    model = JSelfGNN(mc, USERS, ITEMS, mesh=mesh)

    def loss_fn(p, graphs, batch):
        pre, ssl, _ = model.train_losses(p, graphs, batch, None)
        return (pre + TRAIN["reg"] * j_reg_loss(p)
                + TRAIN["ssl_reg"] * ssl), pre

    with mesh:
        params = jax.device_put(env["jparams"], j_param_shardings(
            rules, env["jparams"]))
        graphs, batch = j_shard_inputs(rules, jax_graphs(env, mc),
                                       env["jbatch"])
        (loss, pre), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, graphs, batch)
    return float(loss), float(pre), flatten_tree(numpy_tree(grads))


def port_mesh_step(env, cfg, shape, tmp_path):
    """(totals, whole gradients) of the port's mesh step on env's weights
    and batch, without the update."""
    tr = Trainer(cfg, env["bundle"], ckpt_root=str(tmp_path),
                 mesh=cpu_mesh(*shape))
    tr.load_imported_params(env["params"])
    totals, grads = tr._mesh_step.loss_and_grads(tr.mesh_state,
                                                 env["batch"])
    specs = tr.mesh_state.specs
    return totals, {k: shd.gather(v, specs[k], torch.device("cpu")).numpy()
                    for k, v in grads.items()}


def grads_close(got, want, rtol=1e-4, atol_share=1e-6):
    g_max = max(float(np.abs(w).max()) for w in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], w, rtol=rtol,
                                   atol=atol_share * g_max, err_msg=k)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_tp_mesh_step_matches_jax_sharded_step(env, tmp_path, option):
    """One step on a 2 x 2 port mesh, the tables split over two model
    ranks, against JAX's GSPMD step on its 2 x 2 mesh, for each option
    that a tensor-parallel mesh used to refuse."""
    opts, jax_backend = OPTIONS[option]
    want_loss, want_pre, want_g = jax_sharded_step(
        env, JModelConfig(**MODEL, spmm_backend=jax_backend, **opts))
    totals, got = port_mesh_step(env, port_cfg(**opts), (2, 2), tmp_path)
    bf16 = option == "fusion_dtype"
    rtol = 1e-2 if bf16 else 1e-5
    np.testing.assert_allclose(float(totals["loss"]), want_loss, rtol=rtol)
    np.testing.assert_allclose(float(totals["preLoss"]), want_pre,
                               rtol=rtol)
    if bf16:
        grads_close(got, want_g, rtol=0.05, atol_share=5e-2)
    else:
        grads_close(got, want_g)


def test_medium_mesh_variant_matches_xla(env, tmp_path):
    """tests/test_medium_mesh.py's variant on a 2 x 2 port mesh: source
    sharding in windows that do not divide the tables (20 rows: 3 user
    shards, 4 item shards, the last ones short) with the fold; its
    first-epoch losses equal the "xla" backend's at rtol 1e-6 (same
    weights from the same seed, same batches)."""
    out = {}
    for name, backend, opts in (
            ("xla", "xla", {}),
            ("pallas_srcshard_fold", "pallas",
             {"spmm_src_shard_rows": 20, "spmm_fold_gather": True})):
        tr = Trainer(port_cfg(backend, **opts), env["bundle"],
                     ckpt_root=str(tmp_path / name), mesh=cpu_mesh(2, 2))
        if opts:
            ss = tr.graphs["plans_ss"]
            assert (ss["u_ptr"].shape[1], ss["i_ptr"].shape[1]) == (4, 3)
        out[name] = tr.train_epoch(verbose=False)
        assert np.isfinite(out[name]["Loss"]), name
    for k in ("Loss", "preLoss"):
        np.testing.assert_allclose(out["pallas_srcshard_fold"][k],
                                   out["xla"][k], rtol=1e-6, err_msg=k)


# -- the tensor-parallel hops against the unsharded ones -------------------------

@pytest.fixture(scope="module")
def hop_env(env):
    """The port's graphs with the attention attachments and 16-row source
    shards, cut over 3 model ranks (the last one short)."""
    b = env["bundle"]
    mc = port_cfg(edge_attention=True).model
    g = graphs_to_device(compile_interval_graphs(b.sub_mats), "cpu", mc,
                         b.sub_mats)
    g["plans_ss"] = graphs_to_device(
        compile_interval_graphs(b.sub_mats), "cpu",
        port_cfg(spmm_src_shard_rows=16).model)["plans_ss"]
    dev = torch.device("cpu")
    return g, shd.tp_graphs({dev: g}, [dev] * 3, USERS, ITEMS)


def _tables(seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
            for n in (ITEMS, USERS, USERS)]      # x (items), y, cotangent


@pytest.mark.parametrize("folded", [False, True])
def test_tp_src_sharded_hop_matches_the_whole_hop(hop_env, folded):
    """K3 over the source-shard plans cut by each rank's target rows, and
    its backward on the transpose shard plans, equal the unsharded
    source-sharded hop (`spmm_src_sharded`)."""
    g, tp = hop_env
    ss = g["plans_ss"]
    x, _, cot = _tables(0)
    hop = tp.hop("u", 0, True, folded, shard_rows=16)
    assert hop.fwd[1].ptr.shape == (4, 17)          # 4 item shards, 16 rows
    xs = [x[lo:hi].clone().requires_grad_() for lo, hi in tp.item_rows]
    out = torch.cat(shd.tp_spmm(xs, hop))
    dx = torch.cat(torch.autograd.grad(out, xs, cot))
    xw = x.clone().requires_grad_()
    want = sc.spmm_src_sharded(xw, ss["u_src"][0], ss["u_ptr"][0],
                               ss["i_src"][0], ss["i_ptr"][0], 16, True,
                               folded)
    dwant, = torch.autograd.grad(want, xw, cot)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dx, dwant, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("side", ["u", "i"])
def test_tp_attention_hop_matches_the_whole_hop(hop_env, side):
    """K5 -> edge softmax -> K2 on each rank's own edges (their slots
    local: the cuts start at e0 != 0) and the backward through both
    tables, against `attention_propagate` over the whole plan."""
    g, tp = hop_env
    other = "i" if side == "u" else "u"
    tgt_rows, src_rows = tp.rows(side)
    hop = tp.weighted_hop(side, 0, True)
    assert all(e0 > 0 for e0, _ in hop.cuts[1:])
    n_src = ITEMS if side == "u" else USERS
    n_tgt = USERS if side == "u" else ITEMS
    rng = np.random.default_rng(1)
    x, y, cot = (torch.from_numpy(rng.standard_normal((n, 16))
                                  .astype(np.float32))
                 for n in (n_src, n_tgt, n_tgt))
    xs = [x[lo:hi].clone().requires_grad_() for lo, hi in src_rows]
    ys = [y[lo:hi].clone().requires_grad_() for lo, hi in tgt_rows]
    out = torch.cat(shd.tp_attention_spmm(xs, ys, hop))
    grads = torch.autograd.grad(out, xs + ys, cot)
    dx, dy = torch.cat(grads[:3]), torch.cat(grads[3:])
    xw, yw = x.clone().requires_grad_(), y.clone().requires_grad_()
    want = attention_propagate(
        xw, yw, g[f"{side}_src"][0], g[f"{side}_tgt"][0],
        g[f"{side}_ptr"][0], g[f"{other}_src"][0], g[f"{other}_ptr"][0],
        g[f"{other}_from_{side}"][0])
    dxw, dyw = torch.autograd.grad(want, (xw, yw), cot)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dx, dxw, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dy, dyw, rtol=1e-5, atol=1e-6)


def test_tp_remat_recomputes_every_rank_hop(env, monkeypatch, tmp_path):
    """remat_propagation on a 1 x 2 mesh: every rank's hops run again in
    the backward (one checkpoint per interval), the step's values
    unchanged."""
    calls = []
    plain = sc.spmm_apply_plain

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(sc, "spmm_apply_plain", counted)
    counts, results = {}, {}
    for remat in (False, True):
        calls.clear()
        totals, grads = port_mesh_step(
            env, port_cfg(remat_propagation=remat), (1, 2),
            tmp_path / str(remat))
        counts[remat], results[remat] = len(calls), (totals, grads)
    hops = MODEL["graph_num"] * MODEL["gnn_layer"] * 2 * 2   # x 2 ranks
    # forward, backward; with remat the forward again in the backward
    assert counts[False] == 2 * hops and counts[True] == 3 * hops
    assert float(results[True][0]["loss"]) == float(
        results[False][0]["loss"])
    for k, v in results[False][1].items():
        np.testing.assert_allclose(results[True][1][k], v, rtol=1e-6,
                                   atol=1e-9, err_msg=k)
