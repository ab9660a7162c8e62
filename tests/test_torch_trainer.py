"""The port's trainer, checkpoints and training CLI on the CPU: epoch, test
and max lines, the best-NDCG save, a resume that replays the uninterrupted
run exactly, the options it refuses, and the helpers it shares with the
JAX package (metric history, step timer).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sagnn_tpu.train.metrics import MetricsHistory as JMetricsHistory
from sagnn_tpu.utils.profiling import StepTimer as JStepTimer
from sagnn_tpu_torch.config import (Config, ModelConfig, TrainConfig,
                                    resolve_src_sharding)
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.train.checkpoint import CheckpointManager
from sagnn_tpu_torch.train.metrics import MetricsHistory
from sagnn_tpu_torch.train.trainer import Trainer
from sagnn_tpu_torch.utils.profiling import StepTimer

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(epoch=2, backend="pallas", **train):
    model = ModelConfig(latdim=16, graph_num=2, gnn_layer=2, att_layer=1,
                        num_heads=4, ssldim=8, pos_length=10, keep_rate=0.5,
                        spmm_backend=backend)
    tc = dict(lr=2e-3, batch=16, reg=1e-2, ssl_reg=1e-3, epoch=epoch,
              trn_num=32, samp_num=4, ssl_num=3, test_size=8, tst_epoch=1,
              seed=5, save_path="run")
    tc.update(train)
    return Config(model=model, train=TrainConfig(**tc))


@pytest.fixture(scope="module")
def bundle():
    return synthetic_dataset(num_users=48, num_items=64, graph_num=2,
                             test_size=8, seed=2)


def _losses(trainer):
    return trainer.history.data["TrainLoss"]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_run_trains_tests_and_saves(bundle, tmp_path, capsys, backend):
    tr = Trainer(_cfg(backend=backend), bundle, ckpt_root=str(tmp_path),
                 device="cpu")
    best = tr.run()
    out = capsys.readouterr().out
    for line in ("Epoch 0/2, Train: Loss = ", "Epoch 1/2, Test: HR = ",
                 "Epoch 2/2, Test: HR = ", ", max: "):
        assert line in out, line
    assert len(_losses(tr)) == 2 and len(tr.history.data["TestHR"]) == 2
    assert all(np.isfinite(_losses(tr)))
    assert 0.0 <= best["HR"] <= 1.0 and 0.0 < best["NDCG"] <= 1.0
    assert tr.state["step"] == 4 and tr.state["opt_state"].count == 4
    # the best-NDCG save and the per-epoch records: every file committed,
    # no temporary left
    files = sorted(os.listdir(tmp_path / "run"))
    assert files == ["config.json", "epochs.json", "history.json",
                     "rng.json", "state"]
    records = json.loads((tmp_path / "run" / "epochs.json").read_text())
    assert [r["epoch"] for r in records["epochs"]] == [0, 1]
    assert [r["Loss"] for r in records["epochs"]] == _losses(tr)
    assert records["final"]["epoch"] == 2 and records["max"]["NDCG"] == \
        best["NDCG"]
    rng = json.loads((tmp_path / "run" / "rng.json").read_text())
    assert rng["epoch"] in (1, 2)
    saved = CheckpointManager(str(tmp_path), "run").load_config()
    assert saved == tr.cfg


def test_training_moves_the_weights_and_lowers_the_loss(bundle, tmp_path):
    cfg = _cfg(epoch=6)
    tr = Trainer(cfg.replace(model=dataclasses.replace(cfg.model,
                                                       keep_rate=1.0)),
                 bundle, ckpt_root=str(tmp_path), device="cpu")
    before = {k: v.detach().clone() for k, v in tr.state["params"].items()}
    first = tr.train_epoch(verbose=False)
    for _ in range(5):
        last = tr.train_epoch(verbose=False)
    assert last["preLoss"] < first["preLoss"]
    moved = [k for k, v in tr.state["params"].items()
             if not torch.equal(v.detach(), before[k])]
    assert set(moved) == set(before)


def test_resume_replays_the_uninterrupted_run(bundle, tmp_path):
    """A run stopped after epoch 0's best-NDCG save and resumed with
    load_model draws the same batches and dropout masks and reproduces the
    uninterrupted run's losses bit for bit."""
    full = Trainer(_cfg(epoch=3), bundle, ckpt_root=str(tmp_path / "a"),
                   device="cpu")
    full.run()
    first = Trainer(_cfg(epoch=1), bundle, ckpt_root=str(tmp_path / "b"),
                    device="cpu")
    first.run()
    resumed = Trainer(_cfg(epoch=3, load_model="run"), bundle,
                      ckpt_root=str(tmp_path / "b"), device="cpu")
    resumed.run()
    assert _losses(first) == _losses(full)[:1]
    assert _losses(resumed) == _losses(full)
    assert resumed.history.data["TestNDCG"] == full.history.data["TestNDCG"]
    for k, v in full.state["params"].items():
        assert torch.equal(resumed.state["params"][k], v), k


def test_restore_continues_at_the_saved_step(bundle, tmp_path):
    a = Trainer(_cfg(), bundle, ckpt_root=str(tmp_path), device="cpu")
    a.train_epoch(verbose=False)
    a.ckpt.save(a.state, a.history, a.cfg, rng_state=a.capture_rng_state(1))
    nxt = a.train_epoch(verbose=False)
    b = Trainer(_cfg(), bundle, ckpt_root=str(tmp_path), device="cpu")
    assert b.restore_checkpoint() == 1
    assert b.state["step"] == 2 and b.state["opt_state"].count == 2
    assert all(v.requires_grad for v in b.state["params"].values())
    assert b.train_epoch(verbose=False) == nxt


def test_restore_rejects_another_model(bundle, tmp_path):
    a = Trainer(_cfg(), bundle, ckpt_root=str(tmp_path), device="cpu")
    a.ckpt.save(a.state, a.history)
    cfg = _cfg()
    wide = cfg.replace(model=dataclasses.replace(cfg.model, latdim=32))
    b = Trainer(wide, bundle, ckpt_root=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        b.ckpt.restore(b.state)


def test_resume_epoch_formula(tmp_path):
    ck = CheckpointManager(str(tmp_path), "x")
    h = MetricsHistory()
    assert ck.resume_epoch(h, 3) == 0
    h.data["TrainLoss"] = [1.0, 2.0]
    assert ck.resume_epoch(h, 3) == 2 * 3 - 2
    assert ck.resume_epoch(h, 1) == 2
    assert ck.restore({"params": {"a": torch.zeros(1)}})[0] is None


def test_trainer_needs_a_card_unless_asked_for_the_cpu(bundle, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_cfg(), bundle, ckpt_root=str(tmp_path))


@pytest.mark.parametrize("model,mesh,match", [
    ({"seq_parallel": True}, None, "enable per_token_seq_attention"),
    ({"seq_parallel": True, "per_token_seq_attention": True}, None,
     "seq_parallel requires a mesh"),
    ({"seq_parallel": True, "per_token_seq_attention": True,
      "pos_length": 10}, 4, r"pos_length 10 must divide the 'model' axis"),
])
def test_unported_options_raise(bundle, tmp_path, model, mesh, match):
    """seq_parallel is ported (ROADMAP A6(d)); what JAX's Trainer asserts
    about it (trainer.py:184-193) raises ValueError: no per-token
    attention, no mesh, a 'model' axis that does not divide pos_length."""
    from sagnn_tpu_torch.parallel.mesh import make_mesh
    cfg = _cfg()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model))
    kw = {"device": "cpu"} if mesh is None else {
        "mesh": make_mesh(data=1, model=mesh, devices=["cpu"] * mesh)}
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, bundle, ckpt_root=str(tmp_path), **kw)


@pytest.mark.parametrize("model", [{"remat_propagation": True},
                                   {"fusion_chunk_rows": 8}])
def test_memory_options_train_on_the_cpu(bundle, tmp_path, model):
    """remat_propagation and fusion_chunk_rows (48 users, 64 items: 6 and 8
    blocks) train: finite losses, every weight moved."""
    cfg = _cfg(epoch=1)
    tr = Trainer(cfg.replace(model=dataclasses.replace(cfg.model, **model)),
                 bundle, ckpt_root=str(tmp_path), device="cpu")
    before = {k: v.detach().clone() for k, v in tr.state["params"].items()}
    res = tr.train_epoch(verbose=False)
    assert np.isfinite(res["Loss"]) and tr.state["step"] == 2
    assert all(not torch.equal(v.detach(), before[k])
               for k, v in tr.state["params"].items())


def test_auto_source_sharding_past_the_threshold_raises():
    """spmm_src_shard_rows=0 resolves as the JAX Trainer does: off up to
    the 32 MiB table threshold, source sharding in shards of that many
    rows above it (where it raised until K3 was ported, hence the name);
    explicit values and the "xla" backend stay as given."""
    cfg = _cfg()
    assert resolve_src_sharding(cfg, 48, 64).model.spmm_src_shard_rows == -1
    # latdim 16: 32 MiB / (4 B * 16) = 524,288 rows
    assert resolve_src_sharding(
        cfg, 524_289, 10).model.spmm_src_shard_rows == 524_288
    assert resolve_src_sharding(
        cfg, 10, 524_289).model.spmm_src_shard_rows == 524_288
    assert resolve_src_sharding(
        cfg, 524_288, 10).model.spmm_src_shard_rows == -1
    # the flagship: latdim 64, 1,048,576 users -> 131,072-row shards
    wide = cfg.replace(model=dataclasses.replace(cfg.model, latdim=64))
    assert resolve_src_sharding(
        wide, 1_048_576, 786_432).model.spmm_src_shard_rows == 131_072
    for mc in (dataclasses.replace(cfg.model, spmm_src_shard_rows=16),
               dataclasses.replace(cfg.model, spmm_backend="xla")):
        assert resolve_src_sharding(cfg.replace(model=mc), 10 ** 6,
                                    10).model == mc


def test_test_epoch_limits_users_and_gives_rates(bundle, tmp_path):
    tr = Trainer(_cfg(), bundle, ckpt_root=str(tmp_path), device="cpu")
    res = tr.test_epoch(max_users=5)
    for k in ("HR@1", "NDCG@5", "HR@10", "HR", "NDCG"):
        assert 0.0 <= res[k] <= 1.0, k
    # 8 candidates: every positive is inside the top 10
    assert res["HR@10"] == 1.0


def test_throughput_stats(bundle, tmp_path):
    tr = Trainer(_cfg(), bundle, ckpt_root=str(tmp_path), device="cpu")
    tr.train_epoch(verbose=False)
    ts = tr.throughput_stats()
    assert len(tr.step_timer.times) == 2 and len(tr.sample_timer.times) == 2
    assert ts["step_ms_mean"] > 0
    assert ts["step_ms_p50"] <= ts["step_ms_p95"]


def test_metrics_history_matches_jax():
    t, j = MetricsHistory(), JMetricsHistory()
    for h in (t, j):
        h.append("Train", {"Loss": 1.5, "preLoss": 0.25, "other": 3.0})
        h.append("Test", {"HR": 0.5, "NDCG": 0.125})
    assert t.data == j.data and t.num_tests == j.num_tests == 1
    vals = {"HR": 0.123456, "NDCG": 0.5}
    assert t.format_line("Test", 3, 9, vals) == \
        j.format_line("Test", 3, 9, vals)


def test_step_timer_matches_jax():
    times = [0.3, 0.1, 0.25, 0.2, 0.9, 0.05]
    t, j = StepTimer(times=list(times)), JStepTimer(times=list(times))
    for w in (0, 3):
        for p in (0, 50, 95, 100):
            assert t.windowed(w).percentile(p) == j.windowed(w).percentile(p)
        assert t.windowed(w).mean == pytest.approx(j.windowed(w).mean)
    timer = StepTimer()
    timer.tic()
    assert timer.toc() >= 0.0 and len(timer.times) == 1


def test_cli_trains_on_the_cpu(tmp_path):
    cmd = [sys.executable, "-m", "sagnn_tpu_torch.main", "--data",
           "synthetic", "--device", "cpu", "--synth_users", "48",
           "--synth_items", "64", "--graphNum", "2", "--epoch", "2",
           "--trnNum", "32", "--batch", "16", "--testSize", "8",
           "--sslNum", "3", "--sampNum", "4", "--latdim", "16",
           "--num_attention_heads", "4", "--ssldim", "8", "--pos_length",
           "10", "--att_layer", "1", "--tstEpoch", "1", "--spmm_backend",
           "pallas", "--ckpt_root", str(tmp_path), "--save_path", "cli"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Epoch 1/2, Train: Loss = " in out.stdout
    assert ", max: " in out.stdout
    assert os.path.exists(tmp_path / "cli" / "state")
    # a second run with --load_model resumes from the saved epoch
    again = subprocess.run(cmd + ["--load_model", "cli", "--epoch", "3"],
                           capture_output=True, text=True, cwd=ROOT,
                           env=env, timeout=300)
    assert again.returncode == 0, again.stderr[-2000:]
    assert "Model Loaded, resuming at epoch" in again.stdout
    assert "Epoch 2/3, Train: Loss = " in again.stdout


def test_cli_refuses_unported_flags(tmp_path, capsys):
    """The options a mesh once refused are ported (ROADMAP A6(e)): `--remat`
    on a 2 x 2 "pallas" mesh trains an epoch; what the CLI still refuses
    is what JAX refuses: `--seq_parallel` without
    `--per_token_seq_attention` raises ValueError."""
    from sagnn_tpu_torch import main as cli
    mesh = ["--mesh_data", "2", "--mesh_model", "2"]
    ns = cli.parse_args(["--data", "synthetic", "--spmm_backend", "pallas",
                         "--remat"] + mesh)
    assert cli.build_config(ns).model.remat_propagation
    assert (ns.mesh_data, ns.mesh_model) == (2, 2)
    small = ["--data", "synthetic", "--spmm_backend", "pallas", "--device",
             "cpu", "--synth_users", "48", "--synth_items", "64",
             "--graphNum", "2", "--epoch", "1", "--trnNum", "32", "--batch",
             "16", "--testSize", "10", "--sslNum", "2", "--sampNum", "4",
             "--latdim", "16", "--num_attention_heads", "4", "--tstEpoch",
             "1", "--ckpt_root", str(tmp_path)]
    cli.main(small + ["--remat"] + mesh)
    assert "Mesh: data=2 model=2" in capsys.readouterr().out
    assert (tmp_path / "tem" / "state").exists()
    with pytest.raises(ValueError, match="per_token_seq_attention"):
        cli.main(small + ["--seq_parallel"] + mesh)
