"""The 131k full-coverage recipe through the port's CLI at a cut size on
the CPU, and the convergence run's flags, records and band
(`sagnn_tpu_torch.utils.convergence`)."""

import json
import os
import shlex

import pytest

from sagnn_tpu_torch import main as tmain
from sagnn_tpu_torch.utils import convergence as conv

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the recipe at 2,048 x 1,536 x 30k edges: one step of 2,048 users an
# epoch, three epochs, every other flag the recipe's
CUT = ["--synth_users", "2048", "--synth_items", "1536", "--synth_edges",
       "30000", "--synth_test_users", "256", "--trnNum", "2048", "--epoch",
       "3", "--fusion_chunk_rows", "1024", "--device", "cpu"]


def test_m131k_argv_is_the_scripts():
    """The port's copy of scripts/m131k_fullcov.sh's flags."""
    with open(os.path.join(ROOT, "scripts", "m131k_fullcov.sh")) as f:
        text = f.read().replace("\\\n", " ")
    line = next(x for x in text.splitlines()
                if x.startswith("python main.py"))
    assert conv.M131K_ARGV == [a for a in shlex.split(line)[2:]
                               if a != "$@"]


def test_m131k_cli_at_cut_size(tmp_path):
    """Three epochs in process: three tested epochs in the Trainer's
    epochs.json with every step's losses, preLoss falling, the best-NDCG
    checkpoint on disk at the best epoch, and the records read into the
    convergence run's summary and verdict."""
    argv = [a for a in conv.M131K_ARGV if a != "--supervise"] + CUT + [
        "--ckpt_root", str(tmp_path)]
    tmain.main(argv)
    ckpt = tmp_path / "m131k_fullcov"
    with open(ckpt / "epochs.json") as f:
        records = json.load(f)
    eps = records["epochs"]
    assert [e["epoch"] for e in eps] == [0, 1, 2]
    assert all("NDCG" in e and "epoch_s" in e and "test_s" in e
               for e in eps)
    assert all(len(e["steps"]) == 1 and set(e["steps"][0]) == {
        "loss", "preLoss", "regLoss", "sslLoss"} for e in eps)
    assert eps[-1]["preLoss"] < eps[0]["preLoss"]
    assert records["final"]["epoch"] == 3 and records["max"] is not None
    summary = conv.summarise(records, str(ckpt))
    assert summary["checkpoint"]["exists"]
    best = max(eps, key=lambda e: (e["NDCG"], -e["epoch"]))
    assert summary["checkpoint"]["epoch"] == best["epoch"]
    assert records["max"]["epoch"] == best["epoch"]
    with open(ckpt / "history.json") as f:
        hist = json.load(f)
    assert len(hist["TestNDCG"]) == best["epoch"] + 1
    v = summary["verdict"]
    assert v["best_epoch"] == best["epoch"] and set(v["checks"]) == {
        "best_ndcg", "best_hr", "best_epoch", "tail_ndcg", "last_preloss"}
    assert not v["checks"]["tail_ndcg"]     # 3 epochs, not 20


@pytest.mark.parametrize("ndcg, met", [(0.0112, True), (0.0085, False)])
def test_verdict_holds_each_clause(ndcg, met):
    """60 epochs whose best NDCG is `ndcg` at epoch 25, the tail inside the
    band and the last preLoss 0.42: met only inside the band."""
    eps = []
    for ep in range(60):
        pre = 2.28 - ep * (2.28 - 0.42) / 59
        best = ep == 25
        eps.append({"epoch": ep, "Loss": pre + 9.0, "preLoss": pre,
                    "HR": 0.0148 if best else 0.0130,
                    "NDCG": ndcg if best else 0.0079, "step_ms": 80.5,
                    "epoch_s": 2.8, "test_s": 0.17, "peak_gb": 6.04})
    rec = {"epochs": eps, "final": {"HR": 0.013, "NDCG": 0.008, "epoch": 60},
           "max": {"HR": 0.0148, "NDCG": ndcg, "epoch": 25}}
    v = conv.verdict(rec)
    assert v["best_epoch"] == 25 and v["met"] is met
    assert v["checks"]["best_ndcg"] is met
    assert all(v["checks"][k] for k in ("best_hr", "best_epoch",
                                        "tail_ndcg", "last_preloss"))
    s = conv.summarise(rec, "/nonexistent")
    assert s["step_ms_median"] == 80.5 and s["peak_gb"] == 6.04
    assert not s["checkpoint"]["exists"]
