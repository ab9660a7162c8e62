"""The port's training path against the JAX package and the executed TF1
reference: K1's gradient (`SpmmFunction`), the losses and every
parameter's gradient, TF1 Adam with its staircase, and the fixture's
20-step drift.

Tolerances: the segment-sum gradient as the forward (rtol 1e-5, atol
1e-5·sqrt(max degree); bf16 rtol 1e-2); losses rtol 1e-5 and gradients
rtol 1e-4, atol 1e-6·max|g| (the max over the whole gradient) against
JAX; against the TF1 fixture the
tolerances of tests/test_tf_fixture.py (preLoss 1e-5, sslloss 1e-4,
regLoss 1e-5, preds 1e-4/1e-5, grads 5e-3 with atol 2e-4·scale, Adam
1e-4/2e-6, drift 2e-3); the optimizer against optax rtol 1e-6. Parity
runs at keep_rate=1: JAX's dropout draws from jax.random, the port's from
a torch.Generator, and the two streams cannot match.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

from sagnn_tpu.config import Config as JConfig
from sagnn_tpu.config import TrainConfig as JTrainConfig
from sagnn_tpu.data.sampler import Sampler as JSampler
from sagnn_tpu.models.selfgnn import SelfGNN as JSelfGNN
from sagnn_tpu.models.selfgnn import reg_loss as j_reg_loss
from sagnn_tpu.ops.spmm_pallas import plan_spmm, spmm_from_plans
from sagnn_tpu.train.import_tf1 import (LSTM_BIAS, LSTM_KERNEL,
                                        map_reference_params, npz_getter)
from sagnn_tpu.train.trainer import make_optimizer
from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch.convert import (flatten_tree, opt_state_from_numpy,
                                     params_from_numpy)
from sagnn_tpu_torch.data.graph import compile_interval_graphs
from sagnn_tpu_torch.models.selfgnn import (SelfGNN, TrainBatch,
                                            graphs_to_device, reg_loss)
from sagnn_tpu_torch.ops import spmm_cuda
from sagnn_tpu_torch.ops.lstm import dropout_keep_mask, lstm_scan
from sagnn_tpu_torch.train.optim import TF1Adam

from tests.test_tf_fixture import CHECKS, build_batch, build_model_cfg
from tests.torch_port_helpers import MCFG, numpy_tree, setup, torch_cfg
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tf_reference_tiny.npz")


# -- K1's gradient -----------------------------------------------------------

def _bipartite(seed, n_u, n_i, n_edges, pads=5):
    """A U×I edge list with duplicate edges and empty rows on both sides,
    as both directions' target-sorted padded COO + CSR plans, and the
    dense A_u [U, I] (duplicates counted)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_u - 2, n_edges)        # users n_u-2.. empty
    cols = rng.integers(1, n_i, n_edges)            # item 0 empty
    rows = np.concatenate([rows, rows[:4]])         # duplicate edges
    cols = np.concatenate([cols, cols[:4]])
    a = np.zeros((n_u, n_i))
    np.add.at(a, (rows, cols), 1.0)
    m = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n_u, n_i))
    gb = compile_interval_graphs([m], pad_multiple=len(rows) + pads)
    g = graphs_to_device(gb, "cpu")
    return {k: v[0] for k, v in g.items()}, a


def _tol(ptr):
    deg = int((ptr[1:] - ptr[:-1]).max())
    return 1e-5 * np.sqrt(max(1, deg))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("side", ["u", "i"])
def test_spmm_function_grad_matches_jax(exact, side):
    """dx of SpmmFunction (the plain version on the CPU) equals jax.grad
    through the Pallas `spmm` (interpret mode), both directions."""
    g, _ = _bipartite(3, 37, 53, 400)
    other = "i" if side == "u" else "u"
    n_src = g[f"{other}_ptr"].numel() - 1
    n_tgt = g[f"{side}_ptr"].numel() - 1
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n_src, 16)).astype(np.float32)
    cot = rng.standard_normal((n_tgt, 16)).astype(np.float32)

    fwd = plan_spmm(g[f"{side}_src"].numpy(), g[f"{side}_tgt"].numpy(),
                    n_tgt)
    bwd = plan_spmm(g[f"{other}_src"].numpy(), g[f"{other}_tgt"].numpy(),
                    n_src)
    want = np.asarray(jax.grad(lambda x_: jnp.sum(
        spmm_from_plans(x_, fwd, bwd, exact) * cot))(jnp.asarray(x)))

    xt = torch.from_numpy(x).requires_grad_()
    out = spmm_cuda.spmm(xt, g[f"{side}_src"], g[f"{side}_ptr"],
                         g[f"{other}_src"], g[f"{other}_ptr"], exact)
    got, = torch.autograd.grad(out, xt, torch.from_numpy(cot))
    atol = _tol(g[f"{other}_ptr"])
    np.testing.assert_allclose(got.numpy(), want,
                               rtol=1e-5 if exact else 1e-2, atol=atol)


def test_spmm_function_gradcheck():
    """f64 gradcheck on a 20-node graph (8 users, 12 items) with duplicate
    edges and empty rows."""
    g, _ = _bipartite(5, 8, 12, 30)
    x = torch.randn((12, 4), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x_: spmm_cuda.spmm(x_, g["u_src"], g["u_ptr"], g["i_src"],
                                  g["i_ptr"], True), (x,))


def test_backward_plan_is_the_transpose():
    """The backward plan that `_interval_propagation` pairs with each hop
    (the other direction's CSR of the same interval) sums Aᵀ g, with A
    built densely from the edge list, duplicates and empty rows included."""
    g, a = _bipartite(7, 30, 41, 250)
    rng = np.random.default_rng(2)
    x_i = rng.standard_normal((41, 8))
    x_u = rng.standard_normal((30, 8))
    for (side, other, mat, x) in (("u", "i", a, x_i), ("i", "u", a.T, x_u)):
        xt = torch.from_numpy(x).requires_grad_()
        out = spmm_cuda.spmm(xt, g[f"{side}_src"], g[f"{side}_ptr"],
                             g[f"{other}_src"], g[f"{other}_ptr"], True)
        np.testing.assert_allclose(out.detach().numpy(), mat @ x,
                                   rtol=1e-12, atol=1e-12)
        cot = rng.standard_normal(out.shape)
        dx, = torch.autograd.grad(out, xt, torch.from_numpy(cot))
        np.testing.assert_allclose(dx.numpy(), mat.T @ cot, rtol=1e-12,
                                   atol=1e-12)
        plain = spmm_cuda.spmm_apply_plain(torch.from_numpy(cot),
                                           g[f"{other}_src"],
                                           g[f"{other}_ptr"])
        np.testing.assert_allclose(plain.numpy(), mat.T @ cot, rtol=1e-12,
                                   atol=1e-12)


def test_spmm_function_rejects_a_mismatched_backward_plan():
    g, _ = _bipartite(1, 10, 14, 40)
    with pytest.raises(ValueError, match="backward plan"):
        spmm_cuda.spmm(torch.zeros((14, 4)), g["u_src"], g["u_ptr"],
                       g["u_src"], g["u_ptr"], True)


def test_lstm_dropout_masks_come_from_the_generator():
    x = torch.ones((6, 3, 8))
    p = {"kernel": torch.full((16, 32), 0.1), "bias": torch.zeros(32)}

    def scan(seed):
        keep = dropout_keep_mask(torch.Generator().manual_seed(seed),
                                 (6, 3, 8), 0.5, "cpu")
        return lstm_scan(p, x, keep_rate=0.5, keep_mask=keep)

    a, b, c = scan(4), scan(4), scan(5)
    assert torch.equal(a, b) and not torch.equal(a, c)


# -- losses and gradients against the JAX package ----------------------------

@pytest.fixture(scope="module")
def env():
    bundle, _jm, jg, jp, _tm, tg, tp = setup()
    sampler = JSampler(bundle, batch=16, samp_num=5, ssl_num=3, pred_num=5,
                       pos_length=MCFG.pos_length, test_size=9, seed=3,
                       backend="numpy")
    ids = sampler.epoch_user_ids(40)
    batch = sampler.train_batch(ids[:16])
    return bundle, jg, jp, tg, tp, batch


def _torch_batch(jbatch) -> TrainBatch:
    return TrainBatch(*(np.array(getattr(jbatch, f.name))
                        for f in dataclasses.fields(TrainBatch))).to("cpu")


def _port_loss_and_grads(model, params, graphs, batch, reg, ssl_reg):
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    pre, ssl, aux = model.train_losses(p, graphs, batch)
    loss = pre + reg * reg_loss(p) + ssl_reg * ssl
    keys = list(p)
    grads = torch.autograd.grad(loss, [p[k] for k in keys])
    return pre, ssl, aux, dict(zip(keys, grads))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_losses_and_grads_match_jax(env, backend):
    bundle, jg, jp, tg, tp, jbatch = env
    mcfg = dataclasses.replace(MCFG, spmm_backend=backend)
    jm = JSelfGNN(mcfg, bundle.num_users, bundle.num_items)
    reg, ssl_reg = 1e-2, 1e-3

    def loss_fn(p):
        pre, ssl, _ = jm.train_losses(p, jg, jbatch, rng=None)
        return pre + reg * j_reg_loss(p) + ssl_reg * ssl, (pre, ssl)

    (_, (j_pre, j_ssl)), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jp)
    tm = SelfGNN(torch_cfg(mcfg), bundle.num_users, bundle.num_items)
    pre, ssl, _, grads = _port_loss_and_grads(tm, tp, tg,
                                              _torch_batch(jbatch), reg,
                                              ssl_reg)
    np.testing.assert_allclose(pre.item(), float(j_pre), rtol=1e-5)
    np.testing.assert_allclose(ssl.item(), float(j_ssl), rtol=1e-5)
    want = flatten_tree(numpy_tree(j_grads))
    assert set(want) == set(grads)
    # max|g| over the whole gradient: some leaves' exact gradient is 0 (the
    # key biases, q/k of the one-token sequence attention), and there both
    # sides hold f32 rounding noise (~1e-8), which no tolerance relative to
    # the leaf itself can hold
    g_max = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=1e-4,
                                   atol=1e-6 * g_max, err_msg=k)


def test_ssl_loss_grads_alone_match_jax(env):
    """The SSL hinge alone (no preLoss, no L2) and its gradient: the meta
    net's leaves get their gradient from it only, and in the whole loss it
    is a small share that a tolerance scaled by the largest gradient could
    hide."""
    bundle, jg, jp, tg, tp, jbatch = env
    mcfg = dataclasses.replace(MCFG, spmm_backend="xla")
    jm = JSelfGNN(mcfg, bundle.num_users, bundle.num_items)
    j_ssl, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jm.train_losses(p, jg, jbatch, rng=None)[1]))(jp)
    tm = SelfGNN(torch_cfg(mcfg), bundle.num_users, bundle.num_items)
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    ssl = tm.train_losses(p, tg, _torch_batch(jbatch))[1]
    keys = list(p)
    grads = dict(zip(keys, torch.autograd.grad(
        ssl, [p[k] for k in keys], allow_unused=True)))
    np.testing.assert_allclose(ssl.item(), float(j_ssl), rtol=1e-5)
    want = flatten_tree(numpy_tree(j_grads))
    g_max = max(np.abs(w).max() for w in want.values())
    assert g_max > 0
    for k in ("reg/meta2_w", "reg/meta3_w", "free/meta2_b"):
        assert np.abs(want[k]).max() > 1e-3 * g_max, k
    for k, w in want.items():
        got = np.zeros_like(w) if grads[k] is None else grads[k].numpy()
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-6 * g_max,
                                   err_msg=k)


def test_train_losses_need_a_generator_for_dropout(env):
    """With keep_rate < 1 the dropout masks come from `gen`; the same
    generator state gives the same losses, none gives no dropout."""
    bundle, _jg, _jp, tg, tp, jbatch = env
    cfg = dataclasses.replace(torch_cfg(MCFG), keep_rate=0.5)
    model = SelfGNN(cfg, bundle.num_users, bundle.num_items)
    batch = _torch_batch(jbatch)
    a = model.train_losses(tp, tg, batch, torch.Generator().manual_seed(1))
    b = model.train_losses(tp, tg, batch, torch.Generator().manual_seed(1))
    c = model.train_losses(tp, tg, batch, torch.Generator().manual_seed(2))
    assert float(a[0]) == float(b[0]) and float(a[0]) != float(c[0])
    no_drop = SelfGNN(torch_cfg(MCFG), bundle.num_users, bundle.num_items)
    d = no_drop.train_losses(tp, tg, batch)
    e = model.train_losses(tp, tg, batch)
    assert float(d[0]) == float(e[0])


@pytest.mark.parametrize("field,value", [
    ("fusion_chunk_rows", 1), ("fusion_chunk_rows", 16),
    ("remat_propagation", True)])
def test_training_options_not_ported_raise(env, field, value):
    """fusion_chunk_rows (one row per block, and 16) and remat_propagation,
    which training refused until they were ported (hence the name), now
    train and give the losses and gradients of the step without them."""
    bundle, _jg, _jp, tg, tp, jbatch = env
    batch = _torch_batch(jbatch)
    cfg = torch_cfg(MCFG)
    want = _port_loss_and_grads(SelfGNN(cfg, bundle.num_users,
                                        bundle.num_items),
                                tp, tg, batch, 1e-2, 1e-3)
    got = _port_loss_and_grads(
        SelfGNN(dataclasses.replace(cfg, **{field: value}),
                bundle.num_users, bundle.num_items), tp, tg, batch, 1e-2,
        1e-3)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.item(), b.item(), rtol=1e-6)
    g_max = max(float(g.abs().max()) for g in want[3].values())
    for k, w in want[3].items():
        np.testing.assert_allclose(got[3][k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6 * g_max, err_msg=k)


# -- the executed TF1 reference ----------------------------------------------

@pytest.fixture(scope="module")
def fx():
    from sagnn_tpu.data.synthetic import synthetic_dataset
    z = np.load(FIXTURE)
    cfg = json.loads(bytes(z["cfg/json"]).decode())
    jcfg = build_model_cfg(cfg)
    params = params_from_numpy(numpy_tree(
        map_reference_params(npz_getter(z), jcfg)))
    bundle = synthetic_dataset(num_users=cfg["num_users"],
                               num_items=cfg["num_items"],
                               graph_num=jcfg.graph_num, test_size=8,
                               seed=cfg["bundle_seed"])
    graphs = graphs_to_device(
        compile_interval_graphs(bundle.sub_mats, pad_multiple=8), "cpu")
    return z, cfg, jcfg, params, bundle, graphs


def _fixture_model(fx, backend):
    _z, _cfg, jcfg, _p, bundle, _g = fx
    mcfg = tcfg.ModelConfig(**{**jcfg.__dict__, "spmm_backend": backend})
    return SelfGNN(mcfg, bundle.num_users, bundle.num_items)


def _fixture_batch(z, cfg, g, prefix="feed/"):
    return _torch_batch(build_batch(z, cfg, g, prefix))


def _check_key(tf_name):
    return "/".join(str(p) for p in CHECKS[tf_name])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_fixture_losses_and_preds(fx, backend):
    z, cfg, jcfg, params, _bundle, graphs = fx
    model = _fixture_model(fx, backend)
    batch = _fixture_batch(z, cfg, jcfg.graph_num)
    with torch.no_grad():
        pre, ssl, aux = model.train_losses(params, graphs, batch)
    np.testing.assert_allclose(float(pre), float(z["out/preLoss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(ssl), float(z["out/sslloss"]),
                               rtol=1e-4)
    reg_total = (float(cfg["reg"]) * float(reg_loss(params))
                 + float(cfg["ssl_reg"]) * float(ssl))
    np.testing.assert_allclose(reg_total, float(z["out/regLoss"]),
                               rtol=1e-5)
    preds = z["out/preds"]
    P = len(preds) // 2
    np.testing.assert_allclose(aux["pos_pred"].numpy(), preds[:P],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(aux["neg_pred"].numpy(), preds[P:],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_fixture_gradients(fx, backend):
    """d(total loss)/d(params) matches the reference's tf.gradients."""
    z, cfg, jcfg, params, _bundle, graphs = fx
    model = _fixture_model(fx, backend)
    batch = _fixture_batch(z, cfg, jcfg.graph_num)
    *_, grads = _port_loss_and_grads(model, params, graphs, batch,
                                     float(cfg["reg"]), float(cfg["ssl_reg"]))
    for tf_name in CHECKS:
        ref = z[f"grad/{tf_name}"]
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(grads[_check_key(tf_name)].numpy(), ref,
                                   rtol=5e-3, atol=2e-4 * scale,
                                   err_msg=f"grad {tf_name}")


def _fixture_optimizer(cfg) -> TF1Adam:
    tc = tcfg.TrainConfig(lr=float(cfg["lr"]), decay=float(cfg["decay"]),
                          batch=int(cfg["batch"]),
                          trn_num=int(cfg["trnNum"]))
    return TF1Adam(tc.lr, tc.decay, tc.decay_step)


def test_fixture_adam_step(fx):
    """TF1 Adam applied to the reference's captured gradients reproduces
    its post-step variables."""
    z, cfg, *_ = fx
    sub = {name: torch.from_numpy(
        z[f"var/{name}"] if f"var/{name}" in z.files
        else z[f"nns/{name[:-2]}"]).clone() for name in CHECKS}
    grads = {name: torch.from_numpy(z[f"grad/{name}"]) for name in CHECKS}
    opt = _fixture_optimizer(cfg)
    state = opt.init(sub)
    opt.step(sub, grads, state)
    assert state.count == 1
    for name in CHECKS:
        np.testing.assert_allclose(sub[name].numpy(), z[f"post/{name}"],
                                   rtol=1e-4, atol=2e-6, err_msg=name)


def test_fixture_multistep_drift(fx):
    """20 co-training steps from the reference's weights on its captured
    feeds track its preLoss and regLoss trajectory; the run crosses the
    staircase boundary at step 8 (decay_step = trnNum // batch)."""
    z, cfg, jcfg, params, _bundle, graphs = fx
    model = _fixture_model(fx, "pallas")
    reg_w, ssl_w = float(cfg["reg"]), float(cfg["ssl_reg"])
    n = int(z["mstep/n"])
    ref = z["mstep/losses"]              # [N, 3]: preLoss regLoss sslloss
    opt = _fixture_optimizer(cfg)
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    state = opt.init(p)
    pre_hist, reg_hist = [], []
    for s in range(n):
        batch = _fixture_batch(z, cfg, jcfg.graph_num,
                               "feed/" if s == 0 else f"mstep{s}/")
        pre, ssl, _ = model.train_losses(p, graphs, batch)
        reg = reg_w * reg_loss(p) + ssl_w * ssl
        keys = list(p)
        g = torch.autograd.grad(pre + reg, [p[k] for k in keys])
        opt.step(p, dict(zip(keys, g)), state)
        pre_hist.append(pre.item())
        reg_hist.append(reg.item())
    np.testing.assert_allclose(pre_hist, ref[:, 0], rtol=2e-3)
    np.testing.assert_allclose(reg_hist, ref[:, 1], rtol=2e-3)

    def get(name):
        if name == LSTM_KERNEL:
            return z["mfinal/shim_basic_lstm_cell_0/kernel:0"]
        if name == LSTM_BIAS:
            return z["mfinal/shim_basic_lstm_cell_0/bias:0"]
        return z[f"mfinal/{name}:0"]

    ref_final = params_from_numpy(numpy_tree(map_reference_params(get,
                                                                  jcfg)))
    for k, v in p.items():
        drift = float((v.detach() - ref_final[k]).abs().max())
        # test_tf_fixture.py's limits: a few lr units on the exp-attention
        # params with noise-scale gradients, f32 round-off elsewhere
        assert drift < (5e-3 if k.startswith("free/") else 1e-5), (k, drift)


# -- the optimizer against optax ---------------------------------------------

def _adam_case(seed=0):
    rng = np.random.default_rng(seed)
    params = {"reg": {"a": rng.standard_normal((5, 3)).astype(np.float32)},
              "free": {"b": rng.standard_normal(7).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape)
                   * 10.0 ** rng.integers(-6, 1, a.shape)).astype(np.float32),
        params) for _ in range(4)]
    cfg = JConfig(train=JTrainConfig(lr=2e-3, decay=0.5, batch=4,
                                     trn_num=8))           # decay_step 2
    return params, grads, cfg


def test_tf1_adam_matches_jax_across_a_decay_boundary():
    params, grads, cfg = _adam_case()
    opt = make_optimizer(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = opt.init(jp)
    tp = params_from_numpy(params)
    topt = TF1Adam(cfg.train.lr, cfg.train.decay, cfg.train.decay_step)
    ts = topt.init(tp)
    for g in grads[:3]:                     # counts 0, 1 | 2: lr halves
        upd, js = opt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(tp, params_from_numpy(g), ts)
    assert ts.count == 3
    assert topt.learning_rate(1) == pytest.approx(2e-3)
    assert topt.learning_rate(2) == pytest.approx(1e-3)
    adam = js[0]
    for want_tree, got in ((jp, tp), (adam.mu, ts.mu), (adam.nu, ts.nu)):
        want = flatten_tree(numpy_tree(want_tree))
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6,
                                       err_msg=k)


def test_opt_state_from_numpy_continues_the_jax_state():
    """Both optimizers continue from the same moments and count."""
    params, grads, cfg = _adam_case(1)
    opt = make_optimizer(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = opt.init(jp)
    for g in grads[:3]:
        upd, js = opt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
    adam = js[0]
    tp = params_from_numpy(numpy_tree(jp))
    ts = opt_state_from_numpy(numpy_tree(adam.mu), numpy_tree(adam.nu),
                              int(adam.count))
    topt = TF1Adam(cfg.train.lr, cfg.train.decay, cfg.train.decay_step)
    upd, js = opt.update(jax.tree_util.tree_map(jnp.asarray, grads[3]), js,
                         jp)
    jp = optax.apply_updates(jp, upd)
    topt.step(tp, params_from_numpy(grads[3]), ts)
    assert ts.count == 4
    for k, w in flatten_tree(numpy_tree(jp)).items():
        np.testing.assert_allclose(tp[k].numpy(), w, rtol=1e-6, err_msg=k)
