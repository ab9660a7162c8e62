"""Sequence-parallel ring attention (`sagnn_tpu_torch/parallel/
ring_attention.py`) and `seq_parallel` through the sequence branch, the
mesh step, the Trainer, the CLI and the checks, against the JAX package on
its CPU mesh (tests/conftest.py).

The port's mesh names its ranks on the CPU (`make_mesh(devices=["cpu"] *
n)`); a data rank's ring runs over its model row, so JAX's 2 x 4 mesh is
two port rows of four model ranks, each over its half of the batch.
Tolerances:
  * ring attention against JAX's `ring_multi_head_self_attention` and
    against the dense masked MHSA: values rtol/atol 2e-5, gradients in
    the params and x 5e-5 (JAX tests/test_parallel.py:122-156);
  * the seq_parallel sequence branch against JAX's: 2e-5 (JAX
    tests/test_parallel.py:159-183); in bf16, 2 bf16 ulps of its largest
    |value| (tests/test_torch_bf16.py's measure). JAX's ring casts x to
    f32 inside (ring_attention.py:52), so its bf16 branch attends in f32,
    and so does the port's;
  * the mesh step against JAX's GSPMD step, and the mesh Trainer against
    the single-device per-token Trainer: losses rtol 1e-5, gradients rtol
    1e-4 and atol 1e-6 x the largest |g| (tests/test_torch_sharding.py's),
    metrics rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagnn_tpu.config import ModelConfig as JModelConfig
from sagnn_tpu.data.graph import compile_interval_graphs as j_compile
from sagnn_tpu.data.sampler import Sampler as JSampler
from sagnn_tpu.data.synthetic import synthetic_dataset as j_synthetic
from sagnn_tpu.models import selfgnn as js
from sagnn_tpu.models.selfgnn import reg_loss as j_reg_loss
from sagnn_tpu.ops.attention import multi_head_self_attention as j_mhsa
from sagnn_tpu.parallel.distributed import shard_inputs as j_shard_inputs
from sagnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from sagnn_tpu.parallel.ring_attention import \
    ring_multi_head_self_attention as j_ring
from sagnn_tpu.parallel.sharding import ShardingRules as JRules
from sagnn_tpu.parallel.sharding import param_shardings as j_param_shardings
from sagnn_tpu.train.trainer import graphs_to_device as j_graphs
from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch.convert import flatten_tree, params_from_numpy
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.models import selfgnn as ts
from sagnn_tpu_torch.models.selfgnn import SelfGNN, TrainBatch
from sagnn_tpu_torch.ops.attention import multi_head_self_attention
from sagnn_tpu_torch.parallel import sharding as shd
from sagnn_tpu_torch.parallel.mesh import make_mesh
from sagnn_tpu_torch.parallel.ring_attention import \
    ring_multi_head_self_attention
from sagnn_tpu_torch.serve import Recommender
from sagnn_tpu_torch.train.trainer import Trainer

from tests.torch_port_helpers import numpy_tree, t, ulps_of_max
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

MODEL = dict(graph_num=2, gnn_layer=1, att_layer=1, latdim=16, num_heads=4,
             ssldim=8, pos_length=16, keep_rate=1.0,
             per_token_seq_attention=True, seq_parallel=True)
TRAIN = dict(batch=16, samp_num=4, ssl_num=2, trn_num=32, test_size=10,
             reg=1e-2, ssl_reg=1e-3)
USERS, ITEMS = 48, 64


def cpu_mesh(data, model):
    return make_mesh(data=data, model=model, devices=["cpu"] * (data * model))


def port_cfg(backend="pallas", **model):
    return tcfg.Config(model=tcfg.ModelConfig(**{**MODEL, **model},
                                              spmm_backend=backend),
                       train=tcfg.TrainConfig(**TRAIN))


def _attention_inputs(B=6, L=16, D=32, seed=0):
    """MHSA params (non-zero biases), x, a key mask with at least one valid
    key per row and a cotangent, from a numpy seed."""
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(0, 0.3, (D, D) if k[0] == "w" else (D,))
              .astype(np.float32) for k in ("wq", "bq", "wk", "bk", "wv",
                                            "bv")}
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = (rng.random((B, L)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    g = rng.standard_normal((B, L, D)).astype(np.float32)
    return params, x, mask, g


def _port_ring(mesh, params, x, mask, H):
    """The port's ring attention over `mesh`'s rows, each data rank over
    its slice of the batch (JAX's P('data', 'model') layout)."""
    rows = len(mesh.devices)
    return torch.cat([ring_multi_head_self_attention(mesh.row(d), params,
                                                     xb, H, mb)
                      for d, (xb, mb) in enumerate(zip(x.chunk(rows),
                                                       mask.chunk(rows)))])


def test_ring_attention_matches_jax_ring():
    """Values and the gradients in every param and in x, against JAX's ring
    on its 2 x 4 mesh (H 4, 4 tokens per rank)."""
    params, x, mask, g = _attention_inputs()
    H = 4
    mesh = j_make_mesh(data=2, model=4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def j_loss(p, xx):
        return jnp.vdot(j_ring(mesh, p, xx, H, jnp.asarray(mask)), g)

    with mesh:
        want = np.asarray(jax.jit(lambda p, xx: j_ring(
            mesh, p, xx, H, jnp.asarray(mask)))(jp, x))
        j_dp, j_dx = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jp, x)
    tp = {k: t(v).requires_grad_() for k, v in params.items()}
    tx = t(x).requires_grad_()
    got = _port_ring(cpu_mesh(2, 4), tp, tx, t(mask), H)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5,
                               atol=2e-5)
    grads = torch.autograd.grad(got, [tx] + list(tp.values()), t(g))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(j_dx),
                               rtol=5e-5, atol=5e-5)
    for k, dg in zip(tp, grads[1:]):
        np.testing.assert_allclose(dg.numpy(), np.asarray(j_dp[k]),
                                   rtol=5e-5, atol=5e-5, err_msg=k)


@pytest.mark.parametrize("model_ranks", [1, 2, 4, 8])
def test_ring_attention_matches_dense(model_ranks):
    """The port's ring over 1 (JAX's degenerate local step), 2, 4 and 8
    model ranks (2 tokens each) against the port's and JAX's dense masked
    MHSA, values and gradients; a row whose keys are all masked but one
    and a row whose every key is masked (a uniform average, as the dense
    softmax over -1e30 logits) included."""
    params, x, mask, g = _attention_inputs(seed=model_ranks)
    mask[1] = 0.0
    mask[1, 5] = 1.0
    mask[2] = 0.0
    H = 4
    tp = {k: t(v).requires_grad_() for k, v in params.items()}
    tx = t(x).requires_grad_()
    got = ring_multi_head_self_attention(cpu_mesh(1, model_ranks), tp, tx,
                                         H, t(mask))
    dense = multi_head_self_attention(tp, tx, H, stable=True, mask=t(mask))
    want = np.asarray(j_mhsa({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x), H, stable=True,
                             mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(got, dense, rtol=2e-5, atol=2e-5)
    leaves = [tx] + list(tp.values())
    for a, b in zip(torch.autograd.grad(got, leaves, t(g)),
                    torch.autograd.grad(dense, leaves, t(g))):
        torch.testing.assert_close(a, b, rtol=5e-5, atol=5e-5)


def test_ring_attention_refuses_an_uneven_split():
    params, x, mask, _ = _attention_inputs(L=10)
    with pytest.raises(ValueError, match="must divide the 'model' axis"):
        ring_multi_head_self_attention(
            cpu_mesh(1, 4), {k: t(v) for k, v in params.items()}, t(x), 4,
            t(mask))


# -- the sequence branch ---------------------------------------------------------

def _branch_inputs(seed=7, B=6, L=16):
    """Right-padded sequences with one empty user and an item table."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, B)
    lengths[2] = 0
    mask = (np.arange(L)[None, :] >= L - lengths[:, None]).astype(np.float32)
    seq = np.where(mask > 0, rng.integers(1, ITEMS, (B, L)), 0).astype(
        np.int32)
    emb = rng.standard_normal((ITEMS, 16)).astype(np.float32)
    return seq, mask, emb


@pytest.mark.parametrize("fusion_dtype", ["f32", "bf16"])
def test_seq_parallel_branch_matches_jax(fusion_dtype):
    """The seq_parallel sequence branch on two port rows of four model
    ranks against JAX's on its 2 x 4 mesh, and against the port's
    single-device per-token branch."""
    jmc = JModelConfig(**MODEL, fusion_dtype=fusion_dtype)
    jp = js.SelfGNN(jmc, USERS, ITEMS).init(jax.random.PRNGKey(5))
    rng = np.random.default_rng(0)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(
        np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32)), jp)
    seq, mask, emb = _branch_inputs()
    mesh = j_make_mesh(data=2, model=4)
    with mesh:
        want = np.asarray(jax.jit(lambda p, e: js._sequence_branch(
            p, e, seq, mask, jmc, mesh=mesh))(jp, emb))
    mc = tcfg.ModelConfig(**dataclasses.asdict(jmc))
    tp = params_from_numpy(numpy_tree(jp))
    pmesh = cpu_mesh(2, 4)
    got = torch.cat([ts._sequence_branch(tp, t(emb), sb, mb, mc,
                                         pmesh.row(d))
                     for d, (sb, mb) in enumerate(zip(t(seq).chunk(2),
                                                      t(mask).chunk(2)))])
    assert got.dtype == torch.float32 and not got[2].any()
    single = ts._sequence_branch(tp, t(emb), t(seq), t(mask), dataclasses.
                                 replace(mc, seq_parallel=False))
    if fusion_dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(got, single, rtol=2e-5, atol=2e-5)
    else:
        assert ulps_of_max(got.numpy(), want) <= 2.0
        assert ulps_of_max(single.numpy(), want) <= 2.0


# -- the step and the Trainer ----------------------------------------------------

@pytest.fixture(scope="module")
def env():
    jb = j_synthetic(num_users=USERS, num_items=ITEMS, graph_num=2,
                     test_size=10, seed=2)
    sampler = JSampler(bundle=jb, batch=16, samp_num=4, ssl_num=2,
                       pred_num=5, pos_length=16, test_size=10, seed=3,
                       backend="numpy")
    jbatch = sampler.train_batch(sampler.epoch_user_ids(16))
    jp = js.SelfGNN(JModelConfig(**MODEL), USERS, ITEMS).init(
        jax.random.PRNGKey(0))
    return {"jbundle": jb, "jbatch": jbatch, "jparams": jp,
            "params": params_from_numpy(numpy_tree(jp)),
            "batch": TrainBatch(*(np.array(getattr(jbatch, f.name))
                                  for f in dataclasses.fields(TrainBatch))),
            "bundle": synthetic_dataset(num_users=USERS, num_items=ITEMS,
                                        graph_num=2, test_size=10, seed=2)}


def _grads_close(got, want):
    g_max = max(float(np.abs(w).max()) for w in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6 * g_max,
                                   err_msg=k)


def _port_step(env, cfg, shape, tmp_path):
    tr = Trainer(cfg, env["bundle"], ckpt_root=str(tmp_path),
                 mesh=cpu_mesh(*shape))
    tr.load_imported_params(env["params"])
    totals, grads = tr._mesh_step.loss_and_grads(tr.mesh_state,
                                                 env["batch"])
    specs = tr.mesh_state.specs
    return totals, {k: shd.gather(v, specs[k], torch.device("cpu")).numpy()
                    for k, v in grads.items()}


def test_seq_parallel_mesh_step_matches_jax_sharded_step(env, tmp_path):
    """A 2 x 2 port mesh step with seq_parallel (8 tokens per model rank,
    the tables split too) against JAX's GSPMD step on its 2 x 2 mesh."""
    jmc = JModelConfig(**MODEL)
    mesh = j_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    rules = JRules(mesh)
    model = js.SelfGNN(jmc, USERS, ITEMS, mesh=mesh)

    def loss_fn(p, graphs, batch):
        pre, ssl, _ = model.train_losses(p, graphs, batch, None)
        return (pre + TRAIN["reg"] * j_reg_loss(p)
                + TRAIN["ssl_reg"] * ssl), pre

    with mesh:
        params = jax.device_put(env["jparams"], j_param_shardings(
            rules, env["jparams"]))
        graphs, batch = j_shard_inputs(rules, j_graphs(j_compile(
            env["jbundle"].sub_mats, pad_multiple=64)), env["jbatch"])
        (loss, pre), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, graphs, batch)
    totals, got = _port_step(env, port_cfg("xla"), (2, 2), tmp_path)
    np.testing.assert_allclose(float(totals["loss"]), float(loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(totals["preLoss"]), float(pre),
                               rtol=1e-5)
    _grads_close(got, flatten_tree(numpy_tree(grads)))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (2, 1)])
def test_seq_parallel_step_matches_the_per_token_step(env, tmp_path, shape):
    """On "pallas", 1 x 4 (4 tokens per rank), 2 x 2 and 2 x 1 (a ring of
    one) steps equal the single-device per-token step."""
    totals, got = _port_step(env, port_cfg(), shape, tmp_path / "m")
    one = Trainer(port_cfg(seq_parallel=False), env["bundle"],
                  ckpt_root=str(tmp_path / "s"), device="cpu")
    one.load_imported_params(env["params"])
    params = one.state["params"]
    pre, ssl, _ = one.model.train_losses(params, one.graphs,
                                         env["batch"].to("cpu"))
    loss = pre + TRAIN["reg"] * ts.reg_loss(params) + TRAIN["ssl_reg"] * ssl
    keys = list(params)
    want = dict(zip(keys, (g.numpy() for g in torch.autograd.grad(
        loss, [params[k] for k in keys]))))
    np.testing.assert_allclose(float(totals["loss"]), loss.item(),
                               rtol=1e-5)
    np.testing.assert_allclose(float(totals["preLoss"]), pre.item(),
                               rtol=1e-5)
    _grads_close(got, want)


def test_seq_parallel_trainer_matches_the_per_token_trainer(env, tmp_path):
    """`Trainer(mesh=2x2)` with seq_parallel at keepRate 0.5 against the
    single-device per-token Trainer on the same seeds: an epoch's losses
    and the candidate and full-sort metrics (the evaluation runs ring
    attention on each data rank's row)."""
    cfg = port_cfg(keep_rate=0.5)
    one = Trainer(port_cfg(keep_rate=0.5, seq_parallel=False),
                  env["bundle"], ckpt_root=str(tmp_path / "a"),
                  device="cpu")
    mesh = Trainer(cfg, env["bundle"], ckpt_root=str(tmp_path / "b"),
                   mesh=cpu_mesh(2, 2))
    assert all(m.mesh.shape == {"data": 1, "model": 2}
               for m in mesh._mesh_step.row_models)
    for tr in (one, mesh):
        tr.out = tr.train_epoch(verbose=False)
        tr.mets = {fs: tr.test_epoch(full_sort=fs) for fs in (False, True)}
    for k in ("Loss", "preLoss"):
        np.testing.assert_allclose(mesh.out[k], one.out[k], rtol=1e-5)
    for fs in (False, True):
        for k in ("HR", "NDCG"):
            np.testing.assert_allclose(mesh.mets[fs][k], one.mets[fs][k],
                                       rtol=1e-5)


def test_cli_trains_seq_parallel_on_a_mesh(tmp_path, capsys):
    """`main --per_token_seq_attention --seq_parallel --mesh_model 2
    --device cpu` trains, evaluates and checkpoints."""
    from sagnn_tpu_torch import main as cli
    cli.main(["--data", "synthetic", "--device", "cpu", "--spmm_backend",
              "pallas", "--per_token_seq_attention", "--seq_parallel",
              "--mesh_model", "2", "--pos_length", "16", "--synth_users",
              "48", "--synth_items", "64", "--graphNum", "2", "--epoch",
              "1", "--trnNum", "32", "--batch", "16", "--testSize", "10",
              "--sslNum", "2", "--sampNum", "4", "--latdim", "16",
              "--num_attention_heads", "4", "--tstEpoch", "1",
              "--ckpt_root", str(tmp_path)])
    out = capsys.readouterr().out
    assert "Mesh: data=1 model=2" in out and "max" in out
    assert (tmp_path / "tem" / "state").exists()


@pytest.mark.parametrize("model,mesh,match", [
    ({"per_token_seq_attention": False}, (1, 2), "per_token_seq_attention"),
    ({}, None, "requires a mesh"),
    ({"pos_length": 10}, (1, 4), "pos_length 10 must divide")])
def test_seq_parallel_checks_raise_as_jax(env, tmp_path, model, mesh,
                                          match):
    """JAX's Trainer asserts (trainer.py:184-193): seq_parallel without
    per-token attention, without a mesh, with a 'model' axis that does
    not divide pos_length."""
    kw = {"mesh": cpu_mesh(*mesh)} if mesh else {"device": "cpu"}
    with pytest.raises(ValueError, match=match):
        Trainer(port_cfg(**model), env["bundle"], ckpt_root=str(tmp_path),
                **kw)


def test_recommender_refuses_seq_parallel(env):
    """The Recommender has no mesh: a seq_parallel config is refused, as
    JAX's sequence branch asserts without one."""
    with pytest.raises(ValueError, match="mesh"):
        Recommender(port_cfg(), env["bundle"], device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        SelfGNN(port_cfg().model, USERS, ITEMS)
