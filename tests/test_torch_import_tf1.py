"""The port's TF1 checkpoint import (`sagnn_tpu_torch.train.import_tf1`,
`Trainer.load_imported_params`, `main --import_tf1`) against the JAX
package's.

  * The captured fixture (tests/fixtures/tf_reference_tiny.npz) through
    the port's `npz_getter` and `map_reference_params` equals
    `params_from_numpy` of JAX's mapping, bit for bit, keys and dtypes too.
  * A genuine V1 Saver checkpoint (written as tests/test_import_tf1.py
    writes it; needs tensorflow) imports with its Adam moments and global
    step, bit for bit as JAX imports it.
  * Training continues from it: two steps of the port's Trainer after
    `load_imported_params` give JAX's Trainer's epoch losses at rtol 1e-5
    (keep_rate 1, byte-equal batches), on one device and on a mesh of four
    CPU ranks with the ring backend; the params after them rtol 1e-4,
    atol 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

from sagnn_tpu.config import Config as JConfig
from sagnn_tpu.config import ModelConfig as JModelConfig
from sagnn_tpu.config import TrainConfig as JTrainConfig
from sagnn_tpu.data.synthetic import synthetic_dataset as j_synth
from sagnn_tpu.train import import_tf1 as jimport
from sagnn_tpu.train.trainer import Trainer as JTrainer
from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch import main as tmain
from sagnn_tpu_torch.convert import flatten_tree, params_from_numpy
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.parallel.mesh import make_mesh
from sagnn_tpu_torch.train import import_tf1 as timport
from sagnn_tpu_torch.train.trainer import Trainer

from tests.test_torch_fixture import build_model_cfg
from tests.torch_port_helpers import numpy_tree, torch_cfg
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tf_reference_tiny.npz")
# tests/test_import_tf1.py's model and bundle
MODEL = dict(graph_num=2, gnn_layer=1, att_layer=2, latdim=8, num_heads=2,
             ssldim=4, pos_length=16, keep_rate=1.0)
TRAIN = dict(batch=8, samp_num=4, ssl_num=3, trn_num=16, test_size=6,
             epoch=1, tst_epoch=1, lr=1e-3, reg=1e-4, ssl_reg=1e-6, seed=3)
BUNDLE = dict(num_users=24, num_items=36, graph_num=2, test_size=6, seed=3)


def _assert_bit_equal(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), w.numpy(), err_msg=k)


def test_fixture_mapping_matches_jax_bit_for_bit():
    z = np.load(FIXTURE)
    cfg = build_model_cfg(json.loads(bytes(z["cfg/json"]).decode()))
    want = params_from_numpy(numpy_tree(
        jimport.map_reference_params(jimport.npz_getter(z), cfg)))
    got = timport.map_reference_params(timport.npz_getter(z),
                                       torch_cfg(cfg))
    assert set(got) == set(want)
    _assert_bit_equal({k: got[k] for k in want}, want)
    assert (timport.LSTM_KERNEL, timport.LSTM_BIAS) == (jimport.LSTM_KERNEL,
                                                        jimport.LSTM_BIAS)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(prefix, the arrays written, JAX's import of it)."""
    pytest.importorskip("tensorflow")
    from tests.test_import_tf1 import reference_arrays, save_v1_checkpoint

    arrays = reference_arrays(JModelConfig(**MODEL), BUNDLE["num_users"],
                              BUNDLE["num_items"], np.random.default_rng(11))
    # standard-normal weights overflow the raw-exp attention (Q5); a tenth
    # of them trains to finite losses (the Adam moments and step as drawn)
    arrays = {k: v if k in ("Variable", "beta1_power", "beta2_power")
              else v * np.float32(0.1) for k, v in arrays.items()}
    prefix = save_v1_checkpoint(
        arrays, str(tmp_path_factory.mktemp("tf1") / "model"))
    want = jimport.import_tf1_checkpoint(prefix, JModelConfig(**MODEL),
                                         with_optimizer=True)
    return prefix, arrays, want


def test_checkpoint_import_matches_jax(checkpoint):
    prefix, arrays, want = checkpoint
    got = timport.import_tf1_checkpoint(prefix,
                                        tcfg.ModelConfig(**MODEL),
                                        with_optimizer=True)
    assert set(got) == {"params", "mu", "nu", "step"}
    assert got["step"] == want["step"] == 7
    for key in ("params", "mu", "nu"):
        w = params_from_numpy(numpy_tree(want[key]))
        _assert_bit_equal({k: got[key][k] for k in w}, w)
    np.testing.assert_array_equal(got["params"]["free/lstm/kernel"].numpy(),
                                  arrays["rnn/multi_rnn_cell/cell_0/"
                                         "basic_lstm_cell/kernel"])
    np.testing.assert_array_equal(got["mu"]["free/seq_ln/1/scale"].numpy(),
                                  arrays["LayerNorm_5/gamma/Adam"])
    only = timport.import_tf1_checkpoint(prefix, tcfg.ModelConfig(**MODEL))
    assert set(only) == {"params"}


def _port_trainer(tmp_path, mesh=None):
    model = dict(MODEL, spmm_backend="ring" if mesh is not None else "xla")
    cfg = tcfg.Config(model=tcfg.ModelConfig(**model),
                      train=tcfg.TrainConfig(**TRAIN))
    return Trainer(cfg, synthetic_dataset(**BUNDLE), ckpt_root=str(tmp_path),
                   device="cpu", mesh=mesh)


@pytest.mark.parametrize("ring", [False, True])
def test_training_continues_from_the_import_as_in_jax(checkpoint, tmp_path,
                                                      ring):
    prefix, _arrays, want = checkpoint
    jtr = JTrainer(JConfig(model=JModelConfig(**MODEL),
                           train=JTrainConfig(**TRAIN)),
                   j_synth(**BUNDLE), ckpt_root=str(tmp_path / "j"),
                   pad_multiple=8)
    # copies: the jitted step donates the state it is given
    jtr.load_imported_params(**{k: numpy_tree(v) for k, v in want.items()})
    mesh = make_mesh(model=4, devices=["cpu"] * 4) if ring else None
    tr = _port_trainer(tmp_path / "t", mesh)
    tr.load_imported_params(**timport.import_tf1_checkpoint(
        prefix, tr.cfg.model, with_optimizer=True))
    assert tr.state["step"] == 7 and tr.state["opt_state"].count == 7
    assert all(v.requires_grad for v in tr.state["params"].values())
    w_ep = jtr.train_epoch(verbose=False)
    g_ep = tr.train_epoch(verbose=False)
    assert tr.state["step"] == int(jtr.state["step"]) == 9
    for k in ("Loss", "preLoss"):
        assert np.isfinite(g_ep[k]), k
        np.testing.assert_allclose(g_ep[k], w_ep[k], rtol=1e-5, err_msg=k)
    w_params = flatten_tree(numpy_tree(jtr.state["params"]))
    for k, w in w_params.items():
        np.testing.assert_allclose(tr.state["params"][k].detach().numpy(), w,
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_load_imported_params_without_moments_restarts_adam(checkpoint,
                                                            tmp_path):
    prefix, _arrays, _want = checkpoint
    tr = _port_trainer(tmp_path)
    imported = timport.import_tf1_checkpoint(prefix, tr.cfg.model,
                                             with_optimizer=True)
    tr.load_imported_params(imported["params"], step=imported["step"])
    # JAX: a fresh optimizer state at count 0, the step counter as given
    assert tr.state["opt_state"].count == 0 and tr.state["step"] == 7
    assert not any(v.any() for v in tr.state["opt_state"].mu.values())
    assert torch.equal(tr.state["params"]["reg/u_embed"],
                       imported["params"]["reg/u_embed"])


def test_load_imported_params_checks_its_input(tmp_path):
    tr = _port_trainer(tmp_path)
    params = {k: v.detach().clone() for k, v in tr.state["params"].items()}
    bad = dict(params)
    bad["reg/u_embed"] = torch.zeros(2, 5, 8)
    with pytest.raises(ValueError, match="shape"):
        tr.load_imported_params(bad)
    missing = dict(params)
    del missing["free/meta3_b"]
    with pytest.raises(ValueError, match="keys"):
        tr.load_imported_params(missing)
    with pytest.raises(ValueError, match="mu and nu"):
        tr.load_imported_params(params, mu=params)
    with pytest.raises(ValueError, match="mu and nu"):
        tr.load_imported_params(params, nu=params)


def test_cli_import_tf1(checkpoint, tmp_path, capsys):
    """python -m sagnn_tpu_torch.main --import_tf1 PREFIX on the CPU: the
    imported global step is logged and one epoch trains from it."""
    prefix, _arrays, _want = checkpoint
    tmain.main([
        "--data", "synthetic", "--device", "cpu", "--synth_users", "24",
        "--synth_items", "36", "--graphNum", "2", "--gnn_layer", "1",
        "--att_layer", "2", "--latdim", "8", "--num_attention_heads", "2",
        "--ssldim", "4", "--pos_length", "16", "--keepRate", "1.0",
        "--epoch", "1", "--batch", "8", "--trnNum", "16", "--sampNum", "4",
        "--sslNum", "3", "--testSize", "6", "--tstEpoch", "1",
        "--ckpt_root", str(tmp_path), "--import_tf1", prefix])
    out = capsys.readouterr().out
    assert f"Imported TF1 checkpoint {prefix} (global step 7)" in out
    assert "Epoch 0/1, Train: Loss = " in out and ", max: " in out
    assert "nan" not in out.lower()
