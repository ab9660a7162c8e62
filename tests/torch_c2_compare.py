"""The 131k recipe at a cut scale, trained by the JAX package's Trainer and
by the port's `Trainer(draws="jax")` side by side on the CPU, from the
same seed: the same data and batches, the same initial values and the
same dropout masks, both on the plain "xla" backend.

    JAX_PLATFORMS=cpu python -m tests.torch_c2_compare --scale 8 \\
        --epochs 13 --seed 0 --out DIR/eighth_s0.json

`--scale k` divides the recipe's users, items, edges, test users and
trnNum by k (8: 16,384 x 12,288 x 937,500 edges, four steps an epoch);
`--f32` leaves the recipe's `--bf16` out, so both packages run in f32
and differ only in the order of their sums.
Each epoch trains both Trainers, then evaluates both (full sort, as the
recipe). Writes one JSON file: the argv, each package's per-step loss,
preLoss and regLoss (JAX's from its jitted step at full precision) and
per-epoch HR@10 and NDCG@10, and the first step whose loss differs by
more than 1e-3 relative; prints a summary line per epoch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import main as jmain  # noqa: E402
from sagnn_tpu.data.synthetic import synthetic_large_dataset as j_large  # noqa: E402,E501
from sagnn_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from sagnn_tpu_torch import main as tmain  # noqa: E402
from sagnn_tpu_torch.data.synthetic import synthetic_large_dataset  # noqa: E402,E501
from sagnn_tpu_torch.train.trainer import Trainer  # noqa: E402
from sagnn_tpu_torch.utils.convergence import M131K_ARGV  # noqa: E402

CUT = ("--synth_users", "--synth_items", "--synth_edges",
       "--synth_test_users", "--trnNum")
REL = 1e-3


def recipe_argv(scale: int, epochs: int, seed: int, f32: bool = False
                ) -> list:
    drop = ("--supervise", "--bf16") if f32 else ("--supervise",)
    argv = [a for a in M131K_ARGV if a not in drop]
    for flag in CUT:
        i = argv.index(flag)
        argv[i + 1] = str(int(argv[i + 1]) // scale)
    return argv + ["--spmm_backend", "xla", "--epoch", str(epochs),
                   "--seed", str(seed)]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scale", type=int, default=8)
    p.add_argument("--epochs", type=int, default=13)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--f32", action="store_true",
                   help="leave the recipe's --bf16 out (f32 tables and "
                        "fusion stack in both packages)")
    p.add_argument("--out", required=True)
    a = p.parse_args()
    argv = recipe_argv(a.scale, a.epochs, a.seed, a.f32)
    sys.argv = ["main.py"] + argv
    jns = jmain.parse_args()
    jcfg = jmain.build_config(jns)
    tns = tmain.parse_args(argv)
    tcfg = tmain.build_config(tns)
    kw = dict(num_users=tns.synth_users, num_items=tns.synth_items,
              total_edges=tns.synth_edges, graph_num=tcfg.model.graph_num,
              test_size=tcfg.train.test_size,
              num_test_users=tns.synth_test_users, seed=tcfg.train.seed)
    root = tempfile.mkdtemp()
    jtr = JTrainer(jcfg, j_large(**kw), ckpt_root=os.path.join(root, "j"))
    tr = Trainer(tcfg, synthetic_large_dataset(**kw),
                 ckpt_root=os.path.join(root, "t"), device="cpu",
                 draws="jax")
    j_steps, step = [], jtr._train_step

    def recorded(*args):
        state, stats = step(*args)
        j_steps.append(stats)
        return state, stats

    jtr._train_step = recorded
    runs = {"jax": {"steps": [], "hr10": [], "ndcg10": []},
            "port": {"steps": [], "hr10": [], "ndcg10": []}}
    for ep in range(a.epochs):
        jtr.train_epoch(verbose=False)
        runs["jax"]["steps"] += [{k: float(v) for k, v in s.items()}
                                 for s in j_steps]
        j_steps.clear()
        tr.train_epoch(verbose=False)
        runs["port"]["steps"] += [{k: s[k] for k in ("loss", "preLoss",
                                                     "regLoss")}
                                  for s in tr.step_stats]
        for name, res in (("jax", jtr.test_epoch()),
                          ("port", tr.test_epoch())):
            runs[name]["hr10"].append(float(res["HR"]))
            runs[name]["ndcg10"].append(float(res["NDCG"]))
        print(f"epoch {ep}: NDCG@10 jax {runs['jax']['ndcg10'][-1]:.4f} "
              f"port {runs['port']['ndcg10'][-1]:.4f}; last loss jax "
              f"{runs['jax']['steps'][-1]['loss']:.4f} port "
              f"{runs['port']['steps'][-1]['loss']:.4f}", flush=True)
    first = next((i for i, (j, t) in enumerate(zip(runs["jax"]["steps"],
                                                   runs["port"]["steps"]))
                  if abs(t["loss"] - j["loss"]) > REL * abs(j["loss"])),
                 None)
    out = {"argv": argv, "scale": a.scale, "seed": a.seed, "f32": a.f32,
           "first_step_loss_rel_gt_1e-3": first, **runs}
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f)
    print(json.dumps({"out": a.out, "first_step_loss_rel_gt_1e-3": first,
                      "best_ndcg10": {k: max(v["ndcg10"])
                                      for k, v in runs.items()}}))


if __name__ == "__main__":
    main()
