"""The port's bf16 throughput mode (fusion_dtype="bf16", the CLI's --bf16)
against the JAX package's, on the same inputs, bf16 on both sides.

Tolerances, in bf16 ulps of the largest |value| of the JAX output
(`ulps_of_max`: one ulp is 2^(floor(log2 max|want|) - 7)):
  * MHSA (both softmaxes, T <= 16 and the masked T > 16 path) and the
    layer norm: 0, the same bits. Both upcast to f32 where jnp promotes,
    accumulate the norm's mean and variance in f32 and round once.
  * the LSTM: 3 ulps (measured 2). XLA expands the bf16 logistic into
    1 / (1 + exp(-x)) and rounds each step to bf16; the port's
    torch.sigmoid rounds once, so about half the gates differ by an ulp.
  * the fusion stack, the pooled sequence branch and the whole encode: 2
    ulps (measured 1.0-1.1); the f32 propagation before it: rtol 1e-5.
  * gradients of the training loss at keep_rate 1 (JAX jitted): rtol
    0.05 and atol 5e-2 x max|g| over the whole gradient (measured: the
    worst leaf, the LSTM kernel, 3.1e-2 x max|g|); losses rtol 1e-2
    (measured 4.2e-3, sslloss). The bf16 cotangents carry 8 bits, and
    each gate that rounds differently in the forward moves the gradients
    behind it; jitted XLA also rounds the backward in its own order.
  * two Trainer steps of each package from the same weights and batches:
    epoch losses rtol 1e-2 (measured 4.9e-3).
A bf16 config with stable_softmax=False equals one with it on, bit for
bit (bf16 forces the stable softmax, as in JAX).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jmain
from sagnn_tpu.config import Config as JConfig
from sagnn_tpu.config import TrainConfig as JTrainConfig
from sagnn_tpu.data.synthetic import synthetic_dataset as j_synth
from sagnn_tpu.models import selfgnn as js
from sagnn_tpu.ops.attention import layer_norm as j_ln
from sagnn_tpu.ops.attention import multi_head_self_attention as j_mhsa
from sagnn_tpu.ops.lstm import lstm_scan as j_lstm
from sagnn_tpu.train.trainer import Trainer as JTrainer
from sagnn_tpu_torch import main as tmain
from sagnn_tpu_torch.config import Config, TrainConfig
from sagnn_tpu_torch.convert import params_from_numpy
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.models import selfgnn as ts
from sagnn_tpu_torch.models.selfgnn import SelfGNN
from sagnn_tpu_torch.ops.attention import layer_norm as t_ln
from sagnn_tpu_torch.ops.attention import multi_head_self_attention as t_mhsa
from sagnn_tpu_torch.ops.lstm import lstm_scan as t_lstm
from sagnn_tpu_torch.train.trainer import Trainer

from tests.torch_port_helpers import (MCFG, losses_and_grads_vs_jax,
                                      numpy_tree, setup, torch_cfg,
                                      train_batches, ulps_of_max)
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

BF16 = dataclasses.replace(MCFG, fusion_dtype="bf16", spmm_backend="pallas",
                           spmm_exact=False, stable_softmax=True)


def jb(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def tb(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _mhsa_params(rng, d):
    return {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
            for k, s in (("wq", (d, d)), ("bq", (d,)), ("wk", (d, d)),
                         ("bk", (d,)), ("wv", (d, d)), ("bv", (d,)))}


@pytest.mark.parametrize("stable", [False, True])
@pytest.mark.parametrize("T", [3, 20])
def test_mhsa_bf16_matches_jax_bit_for_bit(stable, T):
    """f32 q/k/v, logits, softmax and context from bf16-rounded weights;
    only the output is bf16. T = 20 takes the einsum path with a mask
    (padded keys, one fully masked row)."""
    rng = np.random.default_rng(T)
    x = rng.standard_normal((6, T, 16)).astype(np.float32)
    p = _mhsa_params(rng, 16)
    mask = None
    if T > 16:
        mask = (rng.random((6, T)) > 0.3).astype(np.float32)
        mask[0] = 0.0
    want = j_mhsa({k: jb(v) for k, v in p.items()}, jb(x), 4, stable=stable,
                  mask=None if mask is None else jb(mask))
    got = t_mhsa({k: tb(v) for k, v in p.items()}, tb(x), 4, stable=stable,
                 mask=None if mask is None else tb(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(got), f32(want))


def test_layer_norm_bf16_matches_jax_bit_for_bit():
    """Mean and variance over all axes but the first, accumulated in f32
    and rounded to bf16 once (jnp.mean, jnp.var): PyTorch's bf16 mean,
    var and sum do so on the CPU (the card test checks the card)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((50, 3, 16)) * 2 + 0.5).astype(np.float32)
    sc, sh = rng.standard_normal((2, 16)).astype(np.float32)
    want = j_ln(jb(x), jb(sc), jb(sh))
    got = t_ln(tb(x), tb(sc), tb(sh))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(got), f32(want))
    xb = tb(x)
    assert torch.equal(torch.mean(xb, dim=(1, 2)),
                       xb.float().mean(dim=(1, 2)).bfloat16())
    assert torch.equal(torch.var(xb, dim=(1, 2), unbiased=False),
                       xb.float().var(dim=(1, 2), unbiased=False).bfloat16())
    # and the fusion stack's mean, the sequence branch's sum
    assert torch.equal(torch.mean(xb, dim=1),
                       xb.float().mean(dim=1).bfloat16())
    assert torch.equal(torch.sum(xb, dim=1), xb.float().sum(dim=1).bfloat16())


def test_lstm_bf16_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((60, 3, 16)).astype(np.float32)
    p = {"kernel": (rng.standard_normal((32, 64)) * 0.3).astype(np.float32),
         "bias": (rng.standard_normal(64) * 0.1).astype(np.float32)}
    want = j_lstm({k: jb(v) for k, v in p.items()}, jb(x))
    got = t_lstm({k: tb(v) for k, v in p.items()}, tb(x))
    assert got.dtype == torch.bfloat16
    assert ulps_of_max(f32(got), f32(want)) <= 3.0


@pytest.fixture(scope="module")
def env():
    return setup()


@pytest.mark.parametrize("chunk_rows", [0, 16])
def test_temporal_fusion_bf16_matches_jax(env, chunk_rows):
    """Unchunked, and in blocks of 16 rows (40 users: 16 + 16 + 8, 56
    items: 16 + 16 + 16 + 8, so the last block is a remainder)."""
    bundle, jm, jg, jp, _tm, tg, tp = env
    mc = dataclasses.replace(BF16, fusion_chunk_rows=chunk_rows)
    uv = np.random.default_rng(3).standard_normal(
        (2, bundle.num_users, 16)).astype(np.float32)
    iv = np.random.default_rng(4).standard_normal(
        (2, bundle.num_items, 16)).astype(np.float32)
    want = jax.jit(lambda p, u, i: js._temporal_fusion(
        p, u, i, mc, train=False, rng=None))(jp, uv, iv)
    got = ts._temporal_fusion(tp, torch.from_numpy(uv), torch.from_numpy(iv),
                              torch_cfg(mc))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert ulps_of_max(g.numpy(), np.asarray(w)) <= 2.0


def _seq_inputs(bundle, B=6, L=10, seed=5):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, bundle.num_items, (B, L)).astype(np.int32)
    mask = (rng.random((B, L)) > 0.4).astype(np.float32)
    mask[1] = 0.0                         # a user with no history
    emb = rng.standard_normal((bundle.num_items, 16)).astype(np.float32)
    return seq, mask, emb


def test_pooled_sequence_branch_bf16_matches_jax(env):
    bundle, _jm, _jg, jp, _tm, _tg, tp = env
    seq, mask, emb = _seq_inputs(bundle)
    want = jax.jit(lambda *a: js._sequence_branch(*a, BF16))(
        jp, emb, seq, mask)
    got = ts._sequence_branch(tp, torch.from_numpy(emb),
                              torch.from_numpy(seq), torch.from_numpy(mask),
                              torch_cfg(BF16))
    assert got.dtype == torch.float32
    assert ulps_of_max(got.numpy(), np.asarray(want)) <= 2.0


@pytest.mark.parametrize("chunk_rows", [0, 16])
def test_encode_bf16_matches_jax(env, chunk_rows):
    """The whole encode: the bf16-table propagation (f32 sums, rtol 1e-5)
    and the bf16 fusion stack (2 ulps of the largest value; JAX's own
    bf16-vs-f32 test allows rtol and atol 0.05)."""
    bundle, jm, jg, jp, _tm, tg, tp = env
    mc = dataclasses.replace(BF16, fusion_chunk_rows=chunk_rows)
    jm.cfg = mc
    want = [np.asarray(a) for a in jm.encode(jp, jg, train=False)]
    got = [a.numpy() for a in SelfGNN(torch_cfg(mc), bundle.num_users,
                                      bundle.num_items).encode(tp, tg)]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == np.float32
        assert ulps_of_max(g, w) <= 2.0
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_bf16_forces_the_stable_softmax(env):
    bundle, _jm, _jg, _jp, _tm, tg, tp = env
    seq, mask, emb = _seq_inputs(bundle)
    outs = []
    for stable in (False, True):
        mc = torch_cfg(dataclasses.replace(BF16, stable_softmax=stable))
        model = SelfGNN(mc, bundle.num_users, bundle.num_items)
        fu, fi, _, _ = model.encode(tp, tg)
        att = ts._sequence_branch(tp, fi, torch.from_numpy(seq),
                                  torch.from_numpy(mask), mc)
        outs.append((fu, fi, att))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    # and f32 without the stable softmax is another function
    f32_raw = SelfGNN(torch_cfg(MCFG), bundle.num_users,
                      bundle.num_items).encode(tp, tg)[0]
    assert not torch.equal(f32_raw, outs[0][0])


@pytest.fixture(scope="module")
def batch_env(env):
    bundle, _jm, jg, jp, _tm, tg, tp = env
    return (bundle, jg, jp, tg, tp) + train_batches(bundle)


def test_bf16_losses_and_grads_match_jax(batch_env):
    want_l, want_g, got_l, got_g = losses_and_grads_vs_jax(batch_env, BF16)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-2)
    assert set(want_g) == set(got_g)
    g_max = max(np.abs(w).max() for w in want_g.values())
    for k, w in want_g.items():
        g = got_g[k].numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=0.05, atol=5e-2 * g_max,
                                   err_msg=k)


def _bf16_argv(*extra):
    return ["--data", "synthetic", "--latdim", "16", "--graphNum", "2",
            "--gnn_layer", "2", "--att_layer", "1", "--num_attention_heads",
            "4", "--ssldim", "8", "--pos_length", "10", "--keepRate", "1.0",
            "--batch", "16", "--trnNum", "32", "--sampNum", "4", "--sslNum",
            "3", "--testSize", "8", "--lr", "2e-3", "--reg", "1e-2",
            "--ssl_reg", "1e-3", "--seed", "5", "--spmm_backend", "pallas",
            "--bf16", *extra]


def jax_config(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["main.py"] + list(argv))
    return jmain.build_config(jmain.parse_args())


def test_trainer_bf16_steps_match_jax(monkeypatch, tmp_path):
    """Two steps of each Trainer, built from --bf16 argv by each package's
    build_config, from the same weights and (byte-equal) batches."""
    argv = _bf16_argv()
    jcfg = jax_config(monkeypatch, argv)
    tcfg = tmain.build_config(tmain.parse_args(argv))
    assert tcfg.model.fusion_dtype == "bf16" and not tcfg.model.spmm_exact
    bundle_kw = dict(num_users=48, num_items=64, graph_num=2, test_size=8,
                     seed=2)
    jtr = JTrainer(jcfg, j_synth(**bundle_kw),
                   ckpt_root=str(tmp_path / "j"), pad_multiple=8)
    tr = Trainer(tcfg, synthetic_dataset(**bundle_kw),
                 ckpt_root=str(tmp_path / "t"), device="cpu")
    tr.load_imported_params(params_from_numpy(
        numpy_tree(jtr.state["params"])))
    want = jtr.train_epoch(verbose=False)
    got = tr.train_epoch(verbose=False)
    assert tr.state["step"] == 2
    for k in ("Loss", "preLoss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, err_msg=k)


def _m131k_argv():
    """scripts/m131k_fullcov.sh's flags, the supervisor's included."""
    import os
    import shlex
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "scripts", "m131k_fullcov.sh")
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    line = next(x for x in text.splitlines()
                if x.startswith("python main.py"))
    argv = shlex.split(line)[2:]
    return [a for a in argv if a != "$@"]


def test_m131k_flags_build_jax_config(monkeypatch):
    """The 131k full-coverage run's command line (--bf16, --full_sort,
    --fusion_chunk_rows, the large generator) parses in the port to the
    JAX package's Config."""
    argv = _m131k_argv()
    assert "--bf16" in argv and "--full_sort" in argv
    want = jax_config(monkeypatch, argv)
    ns = tmain.parse_args(argv)
    assert ns.supervise and ns.supervise_wedge_secs > 0
    got = tmain.build_config(ns)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.model.fusion_dtype == "bf16" and got.train.batch == 4096


def test_bf16_config_matches_jax_build_config(monkeypatch):
    """--bf16 gives the JAX package's Config for the same argv, and an
    explicit --fusion_dtype wins over it."""
    for extra in ((), ("--fusion_dtype", "f32")):
        argv = _bf16_argv(*extra)
        want = jax_config(monkeypatch, argv)
        got = tmain.build_config(tmain.parse_args(argv))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.model.fusion_dtype == "f32" and not got.model.spmm_exact
    assert got.model.stable_softmax
    plain = tmain.build_config(tmain.parse_args(_bf16_argv()[:-1]))
    assert (plain.model.fusion_dtype, plain.model.spmm_exact,
            plain.model.stable_softmax) == ("f32", True, False)
    assert isinstance(plain, Config) and isinstance(plain.train, TrainConfig)
    assert isinstance(want, JConfig) and isinstance(want.train, JTrainConfig)
