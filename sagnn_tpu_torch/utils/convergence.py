"""The 131k full-coverage convergence run through the port's CLI, and the
band it is held to.

    python -m sagnn_tpu_torch.utils.convergence --out DIR
        [--no_supervise] [--drop SWITCH ...] [-- extra main.py flags]

runs `python -m sagnn_tpu_torch.main` with the flags of the JAX package's
`scripts/m131k_fullcov.sh` (131,072 users x 98,304 items x 7.5M edges,
graphNum 3, D 64, 8 heads, batch 4096, `--full_sort`, `--bf16`, lr 3e-3,
60 epochs, seed 0, under `--supervise`) with its checkpoints under
`DIR/Models` (override with `--ckpt_root`), then reads the per-epoch
records the Trainer writes beside its checkpoint (`epochs.json`: every
epoch's Train and Test values, step, epoch and test times, peak device
memory and each step's losses; the final and best results). It holds the
result to `BAND` (the JAX package's converged run, STATUS.md item 12:
best full-sort NDCG@10 0.0112 and HR@10 0.0148 at epoch 25, preLoss 2.28
-> 0.42, each held within its stated margin) and checks that the
best-NDCG checkpoint is on disk. It writes the CLI's output to
`DIR/train.log` (supervised, the child's is the checkpoint directory's
`train.log`), `DIR/summary.json` (the per-epoch records included) and
prints the summary without them as one JSON line; it exits 1 when the run
failed or the band was missed. Flags after `--` go to `main.py` after the
recipe's own, so a cut-size run on the CPU is the same command with
`-- --synth_users 2048 ... --device cpu`. The run has no time limit of
its own: the supervisor relaunches a wedged child, and the caller bounds
the whole.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

# scripts/m131k_fullcov.sh's flags (tests/test_torch_convergence.py holds
# the copy to the script)
M131K_ARGV = [
    "--supervise", "--supervise_wedge_secs", "300", "--data", "synthetic",
    "--synth_users", "131072", "--synth_items", "98304",
    "--synth_edges", "7500000", "--synth_test_users", "16384",
    "--graphNum", "3", "--gnn_layer", "2", "--att_layer", "1",
    "--latdim", "64", "--num_attention_heads", "8", "--ssldim", "48",
    "--batch", "4096", "--trnNum", "131072", "--sampNum", "10",
    "--sslNum", "8", "--tstEpoch", "1", "--testSize", "100", "--full_sort",
    "--spmm_backend", "pallas", "--fusion_chunk_rows", "32768", "--bf16",
    "--lr", "3e-3", "--epoch", "60", "--save_path", "m131k_fullcov",
    "--seed", "0",
]

# The JAX run's best NDCG@10 0.0112 and HR@10 0.0148 each within +-20%,
# the best epoch at or before 45 (JAX: 25), the last 20 epochs' NDCG
# inside 0.0075-0.0134 (JAX: 0.0095-0.0111), the last epoch's preLoss at
# or below 0.50 (JAX: 0.42).
BAND = {
    "best_ndcg": (0.0090, 0.0134),
    "best_hr": (0.0118, 0.0178),
    "best_epoch_max": 45,
    "tail_epochs": 20,
    "tail_ndcg": (0.0075, 0.0134),
    "last_preloss_max": 0.50,
}

def verdict(records: Dict, band: Dict = BAND) -> Dict:
    """Each clause of `band` checked on the run's records: the best epoch by
    per-epoch NDCG (the first of equals, as the best-NDCG save keeps it),
    its HR and NDCG, the last `tail_epochs` epochs' NDCG range and the
    last epoch's preLoss. `met` is true when every clause holds."""
    tested = [e for e in records["epochs"] if "NDCG" in e]
    if not tested:
        return {"met": False, "reason": "no Test line"}
    best = max(tested, key=lambda e: (e["NDCG"], -e["epoch"]))
    tail = [e["NDCG"] for e in tested[-band["tail_epochs"]:]]
    last_pre = records["epochs"][-1].get("preLoss", float("inf"))
    checks = {
        "best_ndcg": band["best_ndcg"][0] <= best["NDCG"] <= band["best_ndcg"][1],
        "best_hr": band["best_hr"][0] <= best["HR"] <= band["best_hr"][1],
        "best_epoch": best["epoch"] <= band["best_epoch_max"],
        "tail_ndcg": (len(tail) == band["tail_epochs"]
                      and band["tail_ndcg"][0] <= min(tail)
                      and max(tail) <= band["tail_ndcg"][1]),
        "last_preloss": last_pre <= band["last_preloss_max"],
    }
    return {"met": all(checks.values()), "checks": checks,
            "best_epoch": best["epoch"], "best_ndcg": best["NDCG"],
            "best_hr": best["HR"], "tail_ndcg": [min(tail), max(tail)],
            "last_preloss": last_pre,
            "first_preloss": records["epochs"][0].get("preLoss")}


def _median(xs: List[float]) -> Optional[float]:
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def summarise(records: Dict, ckpt_dir: str, band: Dict = BAND) -> Dict:
    """The verdict on `records` (epochs.json), the stage times (median over
    epochs after the first) and the checkpoint's state: the best-NDCG
    save's epoch from its RNG sidecar (the epoch it resumes at, less one)."""
    eps = records.get("epochs", [])
    later = eps[1:] or eps
    state = os.path.join(ckpt_dir, "state")
    rng_path = os.path.join(ckpt_dir, "rng.json")
    saved_epoch = None
    if os.path.exists(rng_path):
        with open(rng_path) as f:
            saved_epoch = int(json.load(f)["epoch"]) - 1
    peaks = [e["peak_gb"] for e in eps if "peak_gb" in e]
    return {
        "epochs_run": len(eps),
        "verdict": verdict(records, band) if eps else {"met": False},
        "step_ms_median": _median([e["step_ms"] for e in later]),
        "epoch_s_median": _median([e["epoch_s"] for e in later]),
        "test_s_median": _median([e["test_s"] for e in later]),
        "epoch_s_total": sum(e["epoch_s"] for e in eps),
        "peak_gb": max(peaks) if peaks else None,
        "final": records.get("final"), "max": records.get("max"),
        "checkpoint": {"path": state, "exists": os.path.exists(state),
                       "bytes": (os.path.getsize(state)
                                 if os.path.exists(state) else 0),
                       "epoch": saved_epoch},
    }


def _card() -> Optional[str]:
    """nvidia-smi's name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def _option(argv: Sequence[str], flag: str, default: str) -> str:
    """The last value given for `flag` in argv (argparse's rule)."""
    val = default
    for a, b in zip(argv, argv[1:]):
        if a == flag:
            val = b
    return val


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    extra: List[str] = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--ckpt_root")
    p.add_argument("--no_supervise", action="store_true")
    p.add_argument("--drop", action="append", default=[],
                   help="leave this switch of the recipe out (--bf16, "
                        "--full_sort, ...); repeatable")
    ns = p.parse_args(argv)
    os.makedirs(ns.out, exist_ok=True)
    ckpt_root = os.path.abspath(ns.ckpt_root or os.path.join(ns.out,
                                                             "Models"))
    drop = set(ns.drop) | ({"--supervise"} if ns.no_supervise else set())
    flags = [a for a in M131K_ARGV if a not in drop]
    flags += ["--ckpt_root", ckpt_root] + extra
    save_path = _option(flags, "--save_path", "tem")
    ckpt_dir = os.path.join(ckpt_root, save_path)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [q for q in [env.get("PYTHONPATH")] if q])
    cmd = [sys.executable, "-m", "sagnn_tpu_torch.main"] + flags
    print("command: " + " ".join(cmd), flush=True)
    t0 = time.monotonic()
    with open(os.path.join(ns.out, "train.log"), "wb") as log_out:
        rc = subprocess.run(cmd, stdout=log_out, stderr=subprocess.STDOUT,
                            env=env).returncode
    run_s = time.monotonic() - t0
    epochs_json = os.path.join(ckpt_dir, "epochs.json")
    records: Dict = {}
    if os.path.exists(epochs_json):
        with open(epochs_json) as f:
            records = json.load(f)
    summary = summarise(records, ckpt_dir)
    summary["rc"], summary["run_s"] = rc, run_s
    summary["card"] = _card()
    with open(os.path.join(ns.out, "summary.json"), "w") as f:
        json.dump(dict(summary, epochs=records.get("epochs", [])), f,
                  indent=1)
    print(json.dumps(summary), flush=True)
    ok = (rc == 0 and summary["verdict"]["met"]
          and summary["checkpoint"]["exists"])
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
