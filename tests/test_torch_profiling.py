"""The port's profiler hooks on the CPU: `EdgeRateCounter` against JAX's,
`trace` (a no-op without a directory, a torch.profiler trace with one),
and `main --profile_dir`, which profiles a throwaway epoch and leaves the
run that follows unchanged bit for bit.
"""

import glob
import json
import os
import re

import numpy as np
import pytest
import torch

from sagnn_tpu.utils.profiling import EdgeRateCounter as JEdgeRateCounter
from sagnn_tpu.utils.profiling import StepTimer as JStepTimer
from sagnn_tpu_torch import main as tmain
from sagnn_tpu_torch.train import trainer as trainer_mod
from sagnn_tpu_torch.utils.profiling import (EdgeRateCounter, StepTimer,
                                             trace)

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.mark.parametrize("times", [[], [0.5], [0.01, 0.02, 0.04, 0.03],
                                   [0.0, 0.0]])
def test_edge_rate_counter_matches_jax(times):
    got = EdgeRateCounter(123_456_789, StepTimer(list(times)))
    want = JEdgeRateCounter(123_456_789, JStepTimer(list(times)))
    assert got.edges_per_sec == want.edges_per_sec
    assert got.timer.mean == want.timer.mean
    fresh = EdgeRateCounter(10)
    fresh.timer.tic()
    fresh.timer.toc()
    assert fresh.edges_per_sec > 0


def test_trace_none_is_a_no_op(tmp_path):
    with trace(None):
        x = torch.ones(8).sum()
    assert float(x) == 8.0
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_cpu_trace(tmp_path):
    with trace(str(tmp_path / "tr"), cuda=False):
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    ops = [e["name"] for e in events if e.get("cat") == "cpu_op"]
    assert any("mm" in name for name in ops)


def _run_cli(argv, monkeypatch, capsys):
    """main(argv) in this process; the Trainer it built and its stdout
    lines without their timestamps."""
    made = []

    class Recording(trainer_mod.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(trainer_mod, "Trainer", Recording)
    tmain.main(argv)
    out = capsys.readouterr().out
    lines = [re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d: ", "", x)
             for x in out.replace("\r", "\n").splitlines()]
    return made[0], [x for x in lines if "loss" in x.lower()]


def test_profile_dir_leaves_the_run_unchanged(tmp_path, monkeypatch, capsys):
    """The same CLI run with and without --profile_dir (keepRate 0.5, so
    the dropout generator is restored too): final params, Adam moments,
    counts and every logged loss bit for bit equal; the trace is written."""
    base = ["--data", "synthetic", "--device", "cpu", "--synth_users", "48",
            "--synth_items", "64", "--graphNum", "2", "--epoch", "2",
            "--trnNum", "32", "--batch", "16", "--testSize", "8",
            "--sslNum", "3", "--sampNum", "4", "--latdim", "16",
            "--num_attention_heads", "4", "--ssldim", "8", "--pos_length",
            "10", "--att_layer", "1", "--tstEpoch", "1", "--keepRate", "0.5",
            "--spmm_backend", "pallas"]
    plain, plain_log = _run_cli(
        base + ["--ckpt_root", str(tmp_path / "a")], monkeypatch, capsys)
    prof, prof_log = _run_cli(
        base + ["--ckpt_root", str(tmp_path / "b"), "--profile_dir",
                str(tmp_path / "prof")], monkeypatch, capsys)
    assert plain_log and plain_log == prof_log
    assert plain.history.data == prof.history.data
    a, b = plain.state, prof.state
    assert a["step"] == b["step"] == 4
    assert a["opt_state"].count == b["opt_state"].count
    for k in a["params"]:
        for x, y in ((a["params"][k], b["params"][k]),
                     (a["opt_state"].mu[k], b["opt_state"].mu[k]),
                     (a["opt_state"].nu[k], b["opt_state"].nu[k])):
            assert torch.equal(x.detach(), y.detach()), k
    assert torch.equal(plain.dropout_gen.get_state(),
                       prof.dropout_gen.get_state())
    assert (plain.sampler.rng.bit_generator.state
            == prof.sampler.rng.bit_generator.state)
    files = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(files) == 1
    assert np.isfinite(plain.history.data["TrainLoss"]).all()


def test_profile_epoch_restores_state_and_rng(tmp_path):
    """profile_epoch alone: the Trainer's state and both RNGs after it are
    the ones before it, and it logs a positive edge rate."""
    from sagnn_tpu_torch.config import Config, ModelConfig, TrainConfig
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    bundle = synthetic_dataset(num_users=48, num_items=64, graph_num=2,
                               test_size=8, seed=2)
    cfg = Config(model=ModelConfig(latdim=16, graph_num=2, gnn_layer=2,
                                   att_layer=1, num_heads=4, ssldim=8,
                                   pos_length=10, keep_rate=0.5,
                                   spmm_backend="pallas"),
                 train=TrainConfig(batch=16, trn_num=32, samp_num=4,
                                   ssl_num=3, test_size=8, seed=5))
    tr = trainer_mod.Trainer(cfg, bundle, ckpt_root=str(tmp_path),
                             device="cpu")
    before = {k: v.detach().clone() for k, v in tr.state["params"].items()}
    rng = tr.capture_rng_state(0)
    tmain.profile_epoch(tr, str(tmp_path / "p"))
    assert tr.state["step"] == 0 and tr.state["opt_state"].count == 0
    for k, v in tr.state["params"].items():
        assert torch.equal(v.detach(), before[k]) and v.requires_grad
    assert all(float(m.abs().max()) == 0.0
               for m in tr.state["opt_state"].mu.values())
    assert tr.capture_rng_state(0) == rng
    assert EdgeRateCounter(tr.edges_per_step,
                           tr.step_timer).edges_per_sec > 0
