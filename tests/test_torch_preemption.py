"""The Trainer's preemption handler on the CPU: a SIGTERM saves a whole
state wherever it lands. Inside the optimizer update (between Adam's
moments and the params) the save waits for the update's end; inside the
forward pass it is made at once; inside a checkpoint save it waits for
that save to commit. A resume from what was saved continues.
"""

import copy
import signal

import numpy as np
import pytest
import torch

from sagnn_tpu_torch.config import Config, ModelConfig, TrainConfig
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.train.checkpoint import CheckpointManager
from sagnn_tpu_torch.train.trainer import Trainer


def _cfg():
    model = ModelConfig(latdim=16, graph_num=2, gnn_layer=2, att_layer=1,
                        num_heads=4, ssldim=8, pos_length=10, keep_rate=1.0,
                        spmm_backend="pallas")
    return Config(model=model, train=TrainConfig(
        lr=2e-3, batch=16, reg=1e-2, ssl_reg=1e-3, epoch=2, trn_num=32,
        samp_num=4, ssl_num=3, test_size=8, tst_epoch=1, seed=5,
        save_path="pre"))


@pytest.fixture(scope="module")
def bundle():
    return synthetic_dataset(num_users=48, num_items=64, graph_num=2,
                             test_size=8, seed=2)


def _flat(state):
    """Every tensor of a Trainer state, and its counts."""
    opt = state["opt_state"]
    out = {f"p/{k}": v for k, v in state["params"].items()}
    out.update({f"m/{k}": v for k, v in opt.mu.items()})
    out.update({f"v/{k}": v for k, v in opt.nu.items()})
    return out, (int(opt.count), int(state["step"]))


def _same(a, b) -> bool:
    (ta, ca), (tb, cb) = _flat(a), _flat(b)
    return ca == cb and all(torch.equal(ta[k].detach(), tb[k].detach())
                            for k in ta)


@pytest.fixture
def trainer(bundle, tmp_path):
    tr = Trainer(_cfg(), bundle, ckpt_root=str(tmp_path), device="cpu")
    previous = tr.install_preemption_handler()
    yield tr
    for s, h in previous.items():
        signal.signal(s, h)


def _batch(tr):
    ids = tr.sampler.epoch_user_ids(tr.cfg.train.trn_num)[:16]
    return tr.sampler.train_batch(ids).to("cpu")


@pytest.mark.parametrize("where,saved", [("update", "after"),
                                         ("forward", "before")])
def test_sigterm_saves_a_whole_state(trainer, tmp_path, monkeypatch, where,
                                     saved):
    tr = trainer
    batch = _batch(tr)
    tr.train_step(batch)                 # moments and step away from zero
    before = copy.deepcopy(tr.state)
    if where == "update":
        # TF1Adam.step takes sqrt(nu) after updating both moments and
        # before touching the params
        real = torch._foreach_sqrt

        def hook(v):
            signal.raise_signal(signal.SIGTERM)
            return real(v)

        monkeypatch.setattr(torch, "_foreach_sqrt", hook)
    else:
        real = tr.model.train_losses

        def hook(*a, **k):
            signal.raise_signal(signal.SIGTERM)
            return real(*a, **k)

        monkeypatch.setattr(tr.model, "train_losses", hook)
    with pytest.raises(SystemExit) as e:
        tr.train_step(batch)
    assert e.value.code == 128 + signal.SIGTERM
    monkeypatch.undo()
    # the same step, whole, on a twin without the signal (keepRate 1: no
    # dropout draws)
    twin = Trainer(_cfg(), tr.bundle, ckpt_root=str(tmp_path / "twin"),
                   device="cpu")
    twin.state = copy.deepcopy(before)
    twin.train_step(batch)
    after = twin.state
    assert not _same(before, after)    # a mix of the two would show
    got, _ = CheckpointManager(str(tmp_path), "pre").restore(tr.state)
    assert _same(got, after if saved == "after" else before)

    # a resume from the saved state continues, one step at a time
    tr2 = Trainer(_cfg(), tr.bundle, ckpt_root=str(tmp_path), device="cpu")
    tr2.restore_checkpoint()
    assert _same(tr2.state, got)
    losses = tr2.train_step(_batch(tr2))
    assert np.isfinite(float(losses["loss"]))
    assert tr2.state["step"] == got["step"] + 1


def test_sigterm_inside_a_checkpoint_save_waits_for_its_commit(trainer,
                                                               tmp_path):
    """The handler's save never starts inside another save: the first
    commits, then the preemption checkpoint is written."""
    tr = trainer
    tr.train_step(_batch(tr))
    calls = []
    real = tr.ckpt.save

    def save(*a, **k):
        calls.append("enter")
        if len(calls) == 1:
            signal.raise_signal(signal.SIGTERM)
        real(*a, **k)
        calls.append("exit")

    tr.ckpt.save = save
    with pytest.raises(SystemExit):
        tr._checkpoint(tr.capture_rng_state(1))
    assert calls == ["enter", "exit", "enter", "exit"]
    got, _ = CheckpointManager(str(tmp_path), "pre").restore(tr.state)
    assert _same(got, tr.state)
