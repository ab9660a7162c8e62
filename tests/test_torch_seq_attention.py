"""Per-token sequence attention (per_token_seq_attention=True, the
non-parity fix of quirk Q3) in the port against the JAX package: masked
self-attention over every token of the [B, L, D] sequence with the stable
softmax, then the tokens summed under the mask.

Inputs hold padded sequences and one user whose whole sequence is masked.
Tolerances:
  * f32: the branch's output rtol 1e-5, atol 1e-6; the candidate and
    full-catalog scores, which carry the encode's fused stack, rtol 1e-4,
    atol 1e-5 (tests/test_torch_model.py's tolerance for it); the losses
    rtol 1e-5 and every gradient rtol 1e-4, atol 1e-6 x max|g| over the
    whole gradient, as tests/test_torch_train.py holds the pooled branch;
  * bf16 (fusion_dtype="bf16"): the branch 2 bf16 ulps of its largest
    |value| (tests/test_torch_bf16.py's measure; measured 1.0);
  * one training step through each package's Trainer from the same
    weights and batches: epoch losses rtol 1e-5.
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
from sagnn_tpu.data.synthetic import synthetic_dataset as j_synth
from sagnn_tpu.models import selfgnn as js
from sagnn_tpu.train.trainer import Trainer as JTrainer
from sagnn_tpu_torch.config import Config, ModelConfig, TrainConfig
from sagnn_tpu_torch.convert import params_from_numpy
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.models import selfgnn as ts
from sagnn_tpu_torch.models.selfgnn import SelfGNN
from sagnn_tpu_torch.train.trainer import Trainer

from tests.torch_port_helpers import (MCFG, losses_and_grads_vs_jax,
                                      numpy_tree, setup, t, torch_cfg,
                                      train_batches, ulps_of_max)
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

PER_TOKEN = dataclasses.replace(MCFG, per_token_seq_attention=True)
TOL = dict(rtol=1e-5, atol=1e-6)
SCORES = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def env():
    return setup()


@pytest.fixture(scope="module")
def batch_env(env):
    bundle, _jm, jg, jp, _tm, tg, tp = env
    return (bundle, jg, jp, tg, tp) + train_batches(bundle)


def _requests(bundle, B=6, L=10, seed=7):
    """Users, right-padded sequences (random lengths, the pad item 0 in
    the masked slots) and one user with an empty history."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, bundle.num_users, B).astype(np.int32)
    lengths = rng.integers(1, L + 1, B)
    lengths[2] = 0
    mask = (np.arange(L)[None, :] >= L - lengths[:, None]).astype(np.float32)
    seq = np.where(mask > 0, rng.integers(1, bundle.num_items, (B, L)),
                   0).astype(np.int32)
    return users, seq, mask


@pytest.mark.parametrize("fusion_dtype", ["f32", "bf16"])
def test_per_token_branch_matches_jax(env, fusion_dtype):
    bundle, _jm, _jg, jp, _tm, _tg, tp = env
    mc = dataclasses.replace(PER_TOKEN, fusion_dtype=fusion_dtype)
    _users, seq, mask = _requests(bundle)
    emb = np.random.default_rng(8).standard_normal(
        (bundle.num_items, 16)).astype(np.float32)
    want = np.asarray(jax.jit(lambda *a: js._sequence_branch(*a, mc))(
        jp, emb, seq, mask))
    got = ts._sequence_branch(tp, t(emb), t(seq), t(mask), torch_cfg(mc))
    assert got.dtype == torch.float32 and got.shape == (6, 16)
    assert np.isfinite(got.numpy()).all()
    # the empty user's tokens are all masked: the branch gives 0
    assert not got[2].any()
    if fusion_dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        assert ulps_of_max(got.numpy(), want) <= 2.0
    # and it is not the pooled branch
    pooled = ts._sequence_branch(tp, t(emb), t(seq), t(mask), torch_cfg(
        dataclasses.replace(mc, per_token_seq_attention=False)))
    assert not torch.allclose(got, pooled, rtol=1e-2)


def test_per_token_scores_match_jax(env):
    """The serving path: candidate and full-catalog scores of the f32
    per-token model against JAX's."""
    bundle, jm, jg, jp, _tm, tg, tp = env
    jm.cfg = PER_TOKEN
    tm = SelfGNN(torch_cfg(PER_TOKEN), bundle.num_users, bundle.num_items)
    users, seq, mask = _requests(bundle)
    cands = np.random.default_rng(9).integers(
        0, bundle.num_items, (len(users), 9)).astype(np.int32)
    ju, ji, _, _ = jm.encode(jp, jg, train=False)
    tu, ti, _, _ = tm.encode(tp, tg)
    args = [jnp.asarray(a) for a in (users, cands, seq, mask)]
    want = np.asarray(jm.score_with_encodings(jp, ju, ji, *args))
    got = tm.score_with_encodings(tp, tu, ti, t(users), t(cands), t(seq),
                                  t(mask))
    np.testing.assert_allclose(got.numpy(), want, **SCORES)
    want = np.asarray(jm.score_all_items(jp, ju, ji, args[0], args[2],
                                         args[3]))
    got = tm.score_all_items(tp, tu, ti, t(users), t(seq), t(mask))
    np.testing.assert_allclose(got.numpy(), want, **SCORES)


def test_per_token_losses_and_grads_match_jax(batch_env):
    mc = dataclasses.replace(PER_TOKEN, spmm_backend="pallas")
    want_l, want_g, got_l, got_g = losses_and_grads_vs_jax(batch_env, mc)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert set(want_g) == set(got_g)
    g_max = max(np.abs(w).max() for w in want_g.values())
    for k, w in want_g.items():
        np.testing.assert_allclose(got_g[k].numpy(), w, rtol=1e-4,
                                   atol=1e-6 * g_max, err_msg=k)
    # the sequence attention's weights get gradients (in the pooled
    # branch the one-token attention gives q and k none)
    assert np.abs(want_g["free/seq_mhsa/0/wq"]).max() > 0
    assert got_g["free/seq_mhsa/0/wq"].abs().max() > 0


def test_per_token_trainer_step_matches_jax(tmp_path):
    """One step of each package's Trainer at keep_rate 1 from the same
    weights and (byte-equal) batch."""
    model = dict(latdim=16, graph_num=2, gnn_layer=2, att_layer=1,
                 num_heads=4, ssldim=8, pos_length=10, keep_rate=1.0,
                 spmm_backend="pallas", per_token_seq_attention=True)
    train = dict(lr=2e-3, batch=16, reg=1e-2, ssl_reg=1e-3, trn_num=16,
                 samp_num=4, ssl_num=3, test_size=8, seed=5)
    bundle_kw = dict(num_users=48, num_items=64, graph_num=2, test_size=8,
                     seed=2)
    jcfg = JConfig(model=JModelConfig(**model),
                   train=JTrainConfig(**train))
    jtr = JTrainer(jcfg, j_synth(**bundle_kw),
                   ckpt_root=str(tmp_path / "j"), pad_multiple=8)
    tr = Trainer(Config(model=ModelConfig(**model),
                        train=TrainConfig(**train)),
                 synthetic_dataset(**bundle_kw),
                 ckpt_root=str(tmp_path / "t"), device="cpu")
    tr.load_imported_params(params_from_numpy(
        numpy_tree(jtr.state["params"])))
    want = jtr.train_epoch(verbose=False)
    got = tr.train_epoch(verbose=False)
    assert tr.state["step"] == 1
    for k in ("Loss", "preLoss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
