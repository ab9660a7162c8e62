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
from sagnn_tpu.data.synthetic import synthetic_dataset
from sagnn_tpu.models.selfgnn import SelfGNN as JaxSelfGNN
from sagnn_tpu.ops.spmm_pallas import build_stacked_plans as jax_plans
from sagnn_tpu.train.trainer import graphs_to_device as jax_graphs
from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch.convert import params_from_numpy
from sagnn_tpu_torch.data.graph import compile_interval_graphs as t_compile
from sagnn_tpu_torch.models.selfgnn import SelfGNN as TorchSelfGNN
from sagnn_tpu_torch.models.selfgnn import graphs_to_device

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
