"""Training CLI; the port of the repo-root `main.py` (ref: main.py +
Params.py).

    python -m sagnn_tpu_torch.main --data gowalla --spmm_backend pallas
    python -m sagnn_tpu_torch.main --data synthetic --device cpu --epoch 2

The flags keep `main.py`'s names and destinations: a dataset preset plus
overrides. `--device` (default cuda) picks the card or, when asked, the
CPU. `--synth_edges N` switches `--data synthetic` to the vectorised
large-scale generator (the 1M-user flagship is `--synth_users 1048576
--synth_items 786432 --synth_edges 60000000 --graphNum 3`).
`--spmm_backend ring --mesh_model N` trains over a mesh of N model ranks:
the visible cards (`--mesh_data` x N of them), or with `--device cpu` N
ranks on the CPU. `--bf16` is the throughput mode: a bf16 table for the
segment-sum (spmm_exact=False), the fusion stack and sequence branch in
bf16 (fusion_dtype="bf16") and the stable softmax, each unless given
explicitly. `--import_tf1 PREFIX` starts from a reference TF1 Saver
checkpoint (weights, Adam moments and global step; reading it needs
tensorflow). `--profile_dir DIR` writes a torch.profiler trace of one
throwaway epoch under DIR before the run (the state and RNG are restored
after it, so the run is unchanged). `--draws jax` trains from the JAX
package's own initial values and dropout masks for the same `--seed`
(`Trainer(draws="jax")`; not a Config field, so the Config stays JAX's
field for field), on one device or with `--mesh_data`/`--mesh_model`,
where each rank takes its part of the same draws as JAX's mesh Trainer
does. `--supervise` runs the training under
the wedge watchdog (`train/supervisor.py`): the same command without the
supervisor's flags as a child, recovered with `--load_model` when it
wedges or crashes. `--per_token_seq_attention --seq_parallel` with
`--mesh_model M` (M dividing `--pos_length`) runs the sequence attention
as ring attention over each data rank's model row; what JAX refuses
about it raises ValueError. An unknown `--spmm_backend` raises
NotImplementedError.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

from sagnn_tpu_torch.config import (Config, DataConfig, ModelConfig, PRESETS,
                                    TrainConfig)
from sagnn_tpu_torch.utils.logger import log


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="sagnn_tpu_torch trainer")
    p.add_argument("--data", default="yelp")
    p.add_argument("--data_dir", default="./Datasets")
    p.add_argument("--lr", type=float)
    p.add_argument("--batch", type=int)
    p.add_argument("--reg", type=float)
    p.add_argument("--epoch", type=int)
    p.add_argument("--graphNum", type=int, dest="graph_num")
    p.add_argument("--decay", type=float)
    p.add_argument("--save_path")
    p.add_argument("--latdim", type=int)
    p.add_argument("--ssldim", type=int)
    p.add_argument("--sampNum", type=int, dest="samp_num")
    p.add_argument("--testSize", type=int, dest="test_size")
    p.add_argument("--sslNum", type=int, dest="ssl_num")
    p.add_argument("--num_attention_heads", type=int, dest="num_heads")
    p.add_argument("--gnn_layer", type=int)
    p.add_argument("--trnNum", type=int, dest="trn_num")
    p.add_argument("--load_model")
    p.add_argument("--import_tf1",
                   help="prefix of a reference tf.train.Saver checkpoint "
                        "(its Models/<save_path>) to import weights, Adam "
                        "moments and global step from (needs tensorflow "
                        "to read it)")
    p.add_argument("--shoot", type=int)
    p.add_argument("--keepRate", type=float, dest="keep_rate")
    p.add_argument("--tstEpoch", type=int, dest="tst_epoch")
    p.add_argument("--leaky", type=float)
    p.add_argument("--ssl_reg", type=float)
    p.add_argument("--percent", type=float, default=0.0)
    p.add_argument("--pos_length", type=int)
    p.add_argument("--att_layer", type=int)
    p.add_argument("--pred_num", type=int)
    p.add_argument("--test", type=lambda s: s.lower() != "false",
                   dest="test_mode", default=None)
    p.add_argument("--seed", type=int)
    p.add_argument("--draws", choices=["torch", "jax"], default="torch",
                   help="initial values and dropout masks: torch = the "
                        "port's torch.Generators; jax = the JAX package's "
                        "own draws for the same seed (threefry, "
                        "utils/jax_random.py), so a run starts from JAX's "
                        "weights and masks; on a mesh (--mesh_data/"
                        "--mesh_model) the same draws, made whole and "
                        "cut per rank, as JAX's mesh Trainer makes them")
    p.add_argument("--ckpt_root", default="./Models")
    p.add_argument("--uid", type=int, default=-1,
                   help="dump this test-batch row's candidate scores "
                   "(reference --uid debug mode, model.py:460-461)")
    p.add_argument("--spmm_backend", choices=["xla", "pallas", "ring"],
                   help="propagation: xla = plain PyTorch gather + "
                        "scatter_add_, pallas = the CUDA kernels (their "
                        "plain versions on the CPU), ring = the kernels "
                        "edge-partitioned over --mesh_model ranks")
    p.add_argument("--spmm_chunk_size", type=int,
                   help="accepted for the JAX package's flag set; the "
                        "port's CSR plan has no chunks")
    p.add_argument("--spmm_fold_gather", action="store_true", default=None,
                   help="row-folded gathers (the K4 mode; same values)")
    p.add_argument("--spmm_src_shard_rows", type=int,
                   help="source-sharded propagation: rows per shard (0 = "
                        "auto past 32 MiB of table, -1 = off)")
    p.add_argument("--edge_norm", choices=["sym_sqrt", "mean"],
                   help="degree-normalised propagation (weighted "
                        "segment-sum)")
    p.add_argument("--edge_dropout_keep", type=float,
                   help="functional edge dropout in training: keep rate")
    p.add_argument("--edge_attention", action="store_true", default=None,
                   help="edge-attention propagation (SDDMM, edge softmax, "
                        "weighted segment-sum; pallas backend)")
    p.add_argument("--per_token_seq_attention", action="store_true",
                   default=None)
    p.add_argument("--seq_parallel", action="store_true", default=None)
    p.add_argument("--full_sort", action="store_true", default=None,
                   help="evaluate by ranking the positive against the full "
                        "catalog (minus the user's history) instead of the "
                        "999-precomputed-negative protocol")
    p.add_argument("--fusion_dtype", choices=["f32", "bf16"],
                   help="temporal-fusion/attention compute dtype")
    p.add_argument("--bf16", action="store_true", default=None,
                   help="throughput mode (non-parity): bf16 segment-sum "
                        "table, bf16 fusion stack and the stable softmax, "
                        "each unless given explicitly")
    p.add_argument("--fusion_chunk_rows", type=int,
                   help="run the fusion stack in node blocks of this size, "
                        "each recomputed in the backward (0 = off)")
    p.add_argument("--remat", action="store_true", default=None,
                   dest="remat_propagation",
                   help="recompute propagation (and the unchunked fusion) "
                        "in the backward pass")
    p.add_argument("--time_budget_h", type=float,
                   help="stop cleanly at an epoch boundary when the next "
                        "epoch (predicted from the measured mean) would "
                        "exceed this wall-clock budget")
    p.add_argument("--synth_users", type=int, default=2048,
                   help="--data synthetic: number of users")
    p.add_argument("--synth_items", type=int, default=4096,
                   help="--data synthetic: number of items")
    p.add_argument("--synth_edges", type=int, default=0,
                   help="--data synthetic: total edge budget; >0 switches "
                        "to the vectorised large-scale generator")
    p.add_argument("--synth_test_users", type=int, default=4096,
                   help="large-scale generator only: number of held-out "
                        "test users")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="mesh 'data' axis size (0 = no explicit mesh)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="mesh 'model' axis size (the ring's ranks)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--profile_dir",
                   help="write a torch.profiler trace of one throwaway "
                        "epoch here (state and RNG restored after it)")
    p.add_argument("--supervise", action="store_true",
                   help="run under the wedge watchdog "
                        "(train/supervisor.py): detect a hung run (no log "
                        "output and ~zero CPU), SIGTERM it so the "
                        "preemption handler saves, clean staging files, "
                        "probe the card, and relaunch with --load_model")
    p.add_argument("--supervise_wedge_secs", type=float, default=300.0,
                   help="how long the (no-log AND no-CPU) conjunction "
                        "must hold before a wedge is declared")
    p.add_argument("--supervise_max_recoveries", type=int, default=8)
    return p.parse_args(argv)


MODEL_KEYS = {f.name for f in dataclasses.fields(ModelConfig)}
TRAIN_KEYS = {f.name for f in dataclasses.fields(TrainConfig)}


def build_config(ns: argparse.Namespace) -> Config:
    """The dataset's preset (the default Config for others) with every
    given flag as an override; `--bf16` sets spmm_exact=False,
    fusion_dtype="bf16" and stable_softmax=True where those are not given
    (JAX main.py:162-165)."""
    cfg = PRESETS.get(ns.data, Config())
    m_over = {k: v for k, v in vars(ns).items()
              if k in MODEL_KEYS and v is not None}
    if ns.bf16:
        m_over.setdefault("spmm_exact", False)
        m_over.setdefault("fusion_dtype", "bf16")
        m_over.setdefault("stable_softmax", True)
    t_over = {k: v for k, v in vars(ns).items()
              if k in TRAIN_KEYS and v is not None}
    return Config(
        model=dataclasses.replace(cfg.model, **m_over),
        train=dataclasses.replace(cfg.train, **t_over),
        data=DataConfig(data=ns.data, data_dir=ns.data_dir,
                        noise_percent=ns.percent),
    )


def profile_epoch(trainer, logdir: str) -> None:
    """One `train_epoch(verbose=False)` under a torch.profiler trace
    written to `logdir`, then the Trainer's state (params, Adam moments,
    step) and RNGs (sampler and dropout) put back as they were, so the
    run that follows is unchanged (JAX main.py:229-242). Logs the epoch's
    step time. The trace holds the port's `sagnn.` spans."""
    import copy

    from sagnn_tpu_torch.utils.profiling import trace
    state = copy.deepcopy(trainer.state)
    rng = trainer.capture_rng_state(0)
    with trace(logdir, cuda=trainer.device.type == "cuda"):
        trainer.train_epoch(verbose=False)
    timer = trainer.step_timer.windowed(trainer._steps_last_epoch)
    trainer.state = state
    trainer.restore_rng_state(rng)
    log(f"Profile trace written to {logdir}: {len(timer.times)} "
        f"steps, {timer.mean * 1e3:.1f} ms per step")


def main(argv: Optional[Sequence[str]] = None) -> None:
    """argv: the arguments without the program name (sys.argv[1:] by
    default); `--supervise` re-execs them as its child."""
    import sys
    raw = list(sys.argv[1:] if argv is None else argv)
    ns = parse_args(raw)
    cfg = build_config(ns)
    if ns.supervise:
        # the supervisor touches no device: it re-execs these arguments
        # (minus its own flags) as a watched child
        from sagnn_tpu_torch.train.supervisor import supervise_main
        ns.save_path = cfg.train.save_path  # preset-aware
        raise SystemExit(supervise_main(ns, raw))
    from sagnn_tpu_torch.train.supervisor import BLOCKING_SYNC_ENV
    if os.environ.get(BLOCKING_SYNC_ENV) == "1":
        # a supervised child on the card: its host waits sleep, so a hung
        # device op shows as an idle child (before any CUDA call here)
        from sagnn_tpu_torch.device import set_blocking_sync
        set_blocking_sync()
    log("Start")
    if ns.data == "synthetic" and ns.synth_edges > 0:
        from sagnn_tpu_torch.data.synthetic import synthetic_large_dataset
        bundle = synthetic_large_dataset(
            num_users=ns.synth_users, num_items=ns.synth_items,
            total_edges=ns.synth_edges, graph_num=cfg.model.graph_num,
            test_size=cfg.train.test_size,
            num_test_users=ns.synth_test_users, seed=cfg.train.seed)
    elif ns.data == "synthetic":
        from sagnn_tpu_torch.data.synthetic import synthetic_dataset
        bundle = synthetic_dataset(num_users=ns.synth_users,
                                   num_items=ns.synth_items,
                                   graph_num=cfg.model.graph_num,
                                   test_size=cfg.train.test_size,
                                   seed=cfg.train.seed)
    else:
        from sagnn_tpu_torch.data.io import load_dataset
        bundle = load_dataset(cfg.data.predir, cfg.data.noise_percent)
    log(f"Load Data: USER {bundle.num_users} ITEM {bundle.num_items}")
    if bundle.graph_num != cfg.model.graph_num:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, graph_num=bundle.graph_num))
    from sagnn_tpu_torch.train.trainer import Trainer
    mesh = None
    if ns.mesh_data or ns.mesh_model > 1:
        import torch

        from sagnn_tpu_torch.parallel.mesh import make_mesh
        if torch.device(ns.device).type == "cpu":
            data_ax = ns.mesh_data or 1
            mesh = make_mesh(data=data_ax, model=ns.mesh_model,
                             devices=["cpu"] * (data_ax * ns.mesh_model))
        else:
            data_ax = ns.mesh_data or max(
                1, torch.cuda.device_count() // ns.mesh_model)
            mesh = make_mesh(data=data_ax, model=ns.mesh_model)
        log(f"Mesh: data={data_ax} model={ns.mesh_model}")
    trainer = Trainer(cfg, bundle, ckpt_root=ns.ckpt_root, device=ns.device,
                      mesh=mesh, draws=ns.draws)
    trainer.debug_uid = ns.uid
    log("Model Prepared")
    if ns.import_tf1:
        from sagnn_tpu_torch.train.import_tf1 import import_tf1_checkpoint
        imported = import_tf1_checkpoint(ns.import_tf1, cfg.model,
                                         with_optimizer=True)
        trainer.load_imported_params(**imported)
        log(f"Imported TF1 checkpoint {ns.import_tf1} "
            f"(global step {imported['step']})")
    if ns.profile_dir:
        profile_epoch(trainer, ns.profile_dir)
    trainer.run(resume=cfg.train.load_model is not None)


if __name__ == "__main__":
    main()
