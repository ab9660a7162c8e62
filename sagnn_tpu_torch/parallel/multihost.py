"""Multi-process runs of the port over `torch.distributed`; the counterpart
of `scripts/bench_multihost.py`.

    python -m sagnn_tpu_torch.parallel.multihost --mode train --procs 2 \\
        --device cpu
    python -m sagnn_tpu_torch.parallel.multihost --mode ring --procs 4 \\
        --device cpu --edges 60000 --users 4000 --items 3000 --iters 1

The launcher starts `--procs` workers joined over a TCP store on a free
port (gloo; on the card the workers share it, so gloo carries the card's
tensors through host buffers, `parallel/launch.py`), joins them within
`--timeout` seconds, stops the others as soon as one fails, and prints
rank 0's JSON line.

  * ring:  the ring edge-partitioned SpMM with the 'model' axis made of
           the processes, on a random graph every worker draws alike
           (seed 0): one hop per iteration, one K6 launch per bucket
           (`edge_partition.ring_spmm_apply_procs`); the line holds the
           edges/s and a checksum against the dense sum.
  * train: one epoch of a `Trainer` over `global_mesh` ('data' across the
           processes, `--local_devices` data ranks each): each process
           samples its rows of every batch, the gradients and losses are
           summed over the processes; then the candidate and full-sort
           evaluations. The line holds Loss, preLoss, HR, NDCG, fs_HR and
           fs_NDCG, equal to a single-process run on a mesh of as many data
           ranks. The bundle is JAX's test one (48 x 64) unless
           `--data_dir` names one written by `data/io.save_dataset`, which
           every worker loads (`--preset` then sets the widths).
           `--draws jax` trains from the JAX package's initial values and
           masks for the seed (`Trainer(draws="jax")`): every process draws
           the whole tables' from the same key and its ranks take their
           part, as JAX's multi-process Trainer splits the same key in
           every process.

`--device` is cuda unless cpu is asked for.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _tiny_config():
    """bench_multihost.py's configuration (48 users x 64 items), with the
    LSTM dropout at the model's default keepRate 0.5 where it has 1.0, so
    that a run draws masks, which every process must draw alike."""
    from sagnn_tpu_torch.config import Config, ModelConfig, TrainConfig
    return Config(
        model=ModelConfig(graph_num=2, gnn_layer=1, att_layer=1, latdim=16,
                          num_heads=4, ssldim=8, pos_length=16,
                          keep_rate=0.5),
        train=TrainConfig(batch=16, samp_num=4, ssl_num=2, trn_num=32,
                          test_size=10, lr=5e-3))


def train_config(args):
    """The configuration a train worker runs: the preset's (`--preset`) or
    `_tiny_config`, with --spmm_backend and --trn_num when given."""
    from sagnn_tpu_torch.config import PRESETS
    cfg = PRESETS[args.preset] if args.preset else _tiny_config()
    model = dataclasses.replace(cfg.model, spmm_backend=args.spmm_backend)
    train = cfg.train if args.trn_num is None else dataclasses.replace(
        cfg.train, trn_num=args.trn_num)
    return cfg.replace(model=model, train=train)


def load_bundle(args):
    """The worker's dataset: `--data_dir`'s pickles, or JAX's test bundle."""
    if args.data_dir:
        from sagnn_tpu_torch.data.io import load_dataset
        return load_dataset(args.data_dir)
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    return synthetic_dataset(num_users=48, num_items=64, graph_num=2,
                             test_size=10, seed=2)


def _join(args) -> "torch.device":
    import torch
    from sagnn_tpu_torch.device import resolve_device
    from sagnn_tpu_torch.parallel.launch import initialize_distributed
    if args.device == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(f"localhost:{args.port}", args.procs,
                           args.proc_id, backend="gloo")
    return resolve_device(args.device)


def _launches() -> dict:
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    return {k: v for k, v in sc.LAUNCHES.items() if v}


def worker_train(args) -> None:
    import torch
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.parallel import launch
    from sagnn_tpu_torch.parallel.launch import global_mesh
    from sagnn_tpu_torch.train.trainer import Trainer

    device = _join(args)
    bundle = load_bundle(args)
    mesh = global_mesh(model=1, devices=[device] * args.local_devices)
    with tempfile.TemporaryDirectory() as root:
        tr = Trainer(train_config(args), bundle, ckpt_root=root, mesh=mesh,
                     draws=args.draws)
        sc.reset_launches()
        launch.COLLECTIVES.update(calls=0, seconds=0.0)
        t0 = time.perf_counter()
        out = tr.train_epoch(verbose=False)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = len(tr.step_stats)
        collectives = dict(launch.COLLECTIVES)
        train_launches = _launches()
        users = args.eval_users or None
        mets = tr.test_epoch(max_users=users)
        fs = tr.test_epoch(max_users=users, full_sort=True)
    if args.proc_id == 0:
        print(json.dumps({
            "metric": "multihost_train_epoch", "processes": args.procs,
            "global_devices": mesh.shape["data"] * mesh.shape["model"],
            "device": str(device),
            "Loss": out["Loss"], "preLoss": out["preLoss"],
            "HR": mets["HR"], "NDCG": mets["NDCG"],
            "fs_HR": fs["HR"], "fs_NDCG": fs["NDCG"],
            "steps": steps, "epoch_seconds": dt,
            "allreduce_ms_per_step": collectives["seconds"] * 1e3
            / max(1, steps),
            "allreduce_calls": collectives["calls"],
            "launches": train_launches}), flush=True)


def worker_ring(args) -> None:
    import numpy as np
    import torch
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.parallel.edge_partition import (
        partition_edges_ring, plan_ring_buckets, ring_spmm_apply_procs)
    from sagnn_tpu_torch.parallel.launch import all_reduce_sum

    device = _join(args)
    P, p = args.procs, args.proc_id
    rng = np.random.default_rng(0)   # the same graph on every process
    E, U, I, D = args.edges, args.users, args.items, args.latdim
    tgt = np.sort(rng.integers(0, U, E, dtype=np.int32))
    src = rng.integers(0, I, E, dtype=np.int32)
    X = rng.standard_normal((I, D)).astype(np.float32)
    parts = partition_edges_ring(src, tgt, I, U, P)
    rows, srows = parts.rows_per_shard, parts.src_rows_per_shard
    ptr = plan_ring_buckets(parts.src_local, parts.tgt_local, rows, srows)

    def mine(a):                  # this rank's plans as interval 0 of g = 1
        return torch.from_numpy(np.ascontiguousarray(a[p][None])).to(device)

    my_src, my_ptr = mine(parts.src_local), mine(ptr)
    Xp = np.zeros((P * srows, D), np.float32)
    Xp[:I] = X
    block = torch.from_numpy(Xp[p * srows:(p + 1) * srows]).to(device)

    def hop():
        out = ring_spmm_apply_procs(block, my_src, my_ptr, 0, p, P)
        real = max(0, min(rows, U - p * rows))
        return all_reduce_sum([out[:real].double().sum().reshape(1)])[0]

    v = float(hop())                    # warm-up (a first launch builds)
    sc.reset_launches()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        v = float(hop())
    dt = (time.perf_counter() - t0) / args.iters
    if p == 0:
        expect = np.zeros((U, D), np.float64)
        np.add.at(expect, tgt, X[src].astype(np.float64))
        ok = abs(v - float(expect.sum())) < 1e-2 * max(1.0, abs(v))
        print(json.dumps({
            "metric": "multihost_ring_spmm", "processes": P,
            "global_devices": P, "device": str(device),
            "edges_per_sec": E / dt, "hop_ms": dt * 1e3,
            "checksum": v, "checksum_ok": bool(ok),
            "launches": _launches()}), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_workers(args, argv: Sequence[str]) -> int:
    """Start the workers, join them within args.timeout seconds (stopping
    every other one when one fails or the time is out), print rank 0's
    output; returns the exit code (1 on a timeout)."""
    port = args.port or _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [q for q in [env.get("PYTHONPATH")] if q])
    if args.mode == "train":
        # built once here, not raced for by the workers
        from sagnn_tpu_torch.data import native_sampler
        native_sampler.build()
    procs: List[subprocess.Popen] = []
    with tempfile.TemporaryDirectory() as logs:
        errs = [os.path.join(logs, f"worker{i}.err")
                for i in range(args.procs)]
        outs = [os.path.join(logs, f"worker{i}.out")
                for i in range(args.procs)]
        for i in range(args.procs):
            cmd = [sys.executable, "-m", "sagnn_tpu_torch.parallel.multihost",
                   *argv, "--proc_id", str(i), "--port", str(port)]
            with open(outs[i], "wb") as fo, open(errs[i], "wb") as fe:
                procs.append(subprocess.Popen(cmd, stdout=fo, stderr=fe,
                                              env=env, cwd=ROOT))
        deadline = time.monotonic() + args.timeout
        failed = None
        while True:
            codes = [q.poll() for q in procs]
            bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = -1
                break
            time.sleep(0.1)
        for q in procs:
            if q.poll() is None:
                q.kill()
            q.wait()
        if failed is not None:
            who = "timeout" if failed < 0 else f"worker {failed} failed"
            print(f"multihost: {who} after {args.timeout:.0f} s limit",
                  file=sys.stderr)
            for i, path in enumerate(errs):
                with open(path, errors="replace") as f:
                    tail = f.read()[-3000:]
                if tail:
                    print(f"--- worker {i} stderr ---\n{tail}",
                          file=sys.stderr)
            return 1
        with open(outs[0]) as f:
            sys.stdout.write(f.read())
    return 0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["ring", "train"], default="ring")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--local_devices", type=int, default=1,
                    help="data ranks per process (train)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--edges", type=int, default=2_000_000)
    ap.add_argument("--users", type=int, default=100_000)
    ap.add_argument("--items", type=int, default=80_000)
    ap.add_argument("--latdim", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--data_dir", help="train: a bundle written by "
                    "data/io.save_dataset (default: the 48 x 64 test one)")
    ap.add_argument("--preset", help="train: the config preset (with "
                    "--data_dir; default bench_multihost.py's)")
    ap.add_argument("--spmm_backend", default="xla",
                    choices=["xla", "pallas"])
    ap.add_argument("--trn_num", type=int, help="train: users per epoch")
    ap.add_argument("--draws", choices=["torch", "jax"], default="torch",
                    help="train: the initial values and dropout masks from "
                    "torch.Generators, or the JAX package's own draws for "
                    "the seed, made whole in every process and cut per "
                    "rank")
    ap.add_argument("--eval_users", type=int, default=0,
                    help="train: evaluate the first N test users (0: all)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the launcher waits for its workers")
    ap.add_argument("--proc_id", type=int, default=-1,
                    help="internal: this worker's process id")
    ap.add_argument("--port", type=int, default=0,
                    help="the TCP store's port (0: the launcher picks one)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.proc_id >= 0:
        (worker_train if args.mode == "train" else worker_ring)(args)
        return
    raise SystemExit(launch_workers(args, argv))


if __name__ == "__main__":
    main()
