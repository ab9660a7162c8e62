"""Shared set-up for the tests that hold the PyTorch port against the JAX
package: one synthetic bundle, its graphs and one set of weights, handed
to both packages as numpy arrays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sagnn_tpu.config import ModelConfig
from sagnn_tpu.data.graph import compile_interval_graphs
from sagnn_tpu.data.sampler import Sampler as JSampler
from sagnn_tpu.data.synthetic import synthetic_dataset
from sagnn_tpu.models.selfgnn import SelfGNN as JaxSelfGNN
from sagnn_tpu.models.selfgnn import reg_loss as j_reg_loss
from sagnn_tpu.ops.spmm_pallas import build_stacked_plans as jax_plans
from sagnn_tpu.train.trainer import graphs_to_device as jax_graphs
from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch.convert import flatten_tree, params_from_numpy
from sagnn_tpu_torch.data.graph import compile_interval_graphs as t_compile
from sagnn_tpu_torch.models.selfgnn import SelfGNN as TorchSelfGNN
from sagnn_tpu_torch.models.selfgnn import TrainBatch, graphs_to_device
from sagnn_tpu_torch.models.selfgnn import reg_loss as t_reg_loss

MCFG = ModelConfig(graph_num=2, gnn_layer=2, att_layer=2, latdim=16,
                   num_heads=4, ssldim=8, pos_length=10, keep_rate=1.0)


def torch_cfg(mcfg: ModelConfig) -> tcfg.ModelConfig:
    return tcfg.ModelConfig(**dataclasses.asdict(mcfg))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def setup(num_users=40, num_items=56, seed=4, mcfg=MCFG, param_seed=0):
    """(bundle, jax model, jax graphs incl. pallas plans, jax params,
    torch model, torch graphs, torch params): the same weights in both."""
    bundle = synthetic_dataset(num_users=num_users, num_items=num_items,
                               graph_num=mcfg.graph_num, test_size=9,
                               seed=seed)
    gb = compile_interval_graphs(bundle.sub_mats, pad_multiple=8)
    jg = jax_graphs(gb)
    plans = jax_plans(gb.u_src, gb.u_tgt, gb.i_src, gb.i_tgt,
                      gb.num_users, gb.num_items, gb.edge_counts)
    jg["plans"] = {d: {k: jnp.asarray(v) for k, v in plans[d].items()}
                   for d in ("u", "i")}
    jm = JaxSelfGNN(mcfg, num_users, num_items)
    jp = jm.init(jax.random.PRNGKey(param_seed))
    # exercise non-trivial biases / norms (init gives zeros / ones)
    rng = np.random.default_rng(param_seed)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(
            0, 0.05, a.shape).astype(np.float32)), jp)
    tm = TorchSelfGNN(torch_cfg(mcfg), num_users, num_items)
    tg = graphs_to_device(t_compile(bundle.sub_mats, pad_multiple=8), "cpu")
    tp = params_from_numpy(numpy_tree(jp))
    return bundle, jm, jg, jp, tm, tg, tp


def t(a):
    return torch.from_numpy(np.asarray(a))


def no_gradient(key, pooled_seq=True):
    """Leaves whose gradient is zero in exact arithmetic, so that both
    packages move them by rounding noise alone, which Adam's fresh moments
    scale up to a fraction of a step: every MHSA's key bias (the softmax
    is unchanged by a bias added to every key), and, where the sequence
    branch pools (`pooled_seq`; not with per_token_seq_attention), its
    query and key (quirk Q3: attention over one token, whose softmax is
    1)."""
    leaf = key.rsplit("/", 1)[1]
    return leaf == "bk" or (pooled_seq and key.startswith("free/seq_mhsa/")
                            and leaf in ("wq", "bq", "wk"))


def record_steps(jtr):
    """Wrap the JAX Trainer's jitted step so each step's stats are kept."""
    steps, step = [], jtr._train_step

    def recorded(*args):
        state, stats = step(*args)
        steps.append(stats)
        return state, stats

    jtr._train_step = recorded
    return steps


def ulps_of_max(got, want) -> float:
    """max |got - want| in bf16 ulps of max |want|: one ulp is
    2^(floor(log2 max|want|) - 7)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got - want).max() / ulp)


def train_batches(bundle, mcfg=MCFG):
    """One training batch of 16 users (numpy sampler, seed 3) as JAX's
    TrainBatch and as the port's, on the CPU."""
    sampler = JSampler(bundle, batch=16, samp_num=5, ssl_num=3, pred_num=5,
                       pos_length=mcfg.pos_length, test_size=9, seed=3,
                       backend="numpy")
    jbatch = sampler.train_batch(sampler.epoch_user_ids(40)[:16])
    tbatch = TrainBatch(*(np.array(getattr(jbatch, f.name))
                          for f in dataclasses.fields(TrainBatch))).to("cpu")
    return jbatch, tbatch


def losses_and_grads_vs_jax(batch_env, mc, reg=1e-2, ssl_reg=1e-3):
    """((pre, ssl), grads) of JAX (jitted, flattened to the port's keys)
    and of the port for the whole loss at model config `mc`; batch_env is
    (bundle, jax graphs, jax params, torch graphs, torch params, jax
    batch, torch batch)."""
    bundle, jg, jp, tg, tp, jbatch, tbatch = batch_env
    jm = JaxSelfGNN(mc, bundle.num_users, bundle.num_items)

    def loss_fn(p):
        pre, ssl, _ = jm.train_losses(p, jg, jbatch, rng=None)
        return pre + reg * j_reg_loss(p) + ssl_reg * ssl, (pre, ssl)

    (_, (j_pre, j_ssl)), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jp)
    tm = TorchSelfGNN(torch_cfg(mc), bundle.num_users, bundle.num_items)
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    pre, ssl, _ = tm.train_losses(p, tg, tbatch)
    loss = pre + reg * t_reg_loss(p) + ssl_reg * ssl
    keys = list(p)
    grads = dict(zip(keys, torch.autograd.grad(loss, [p[k] for k in keys])))
    return ((float(j_pre), float(j_ssl)), flatten_tree(numpy_tree(j_grads)),
            (pre.item(), ssl.item()), grads)
