"""Typed configuration; the port's copy of `sagnn_tpu/config.py`.

The dataclasses and presets are field-for-field the JAX package's (a test
holds them equal). `ModelConfig.spmm_backend` selects the propagation
path: "xla" runs the plain PyTorch gather + segment-sum
(`ops/segment.py`), "pallas" runs the hand-written CUDA kernels
(`ops/spmm_cuda.py`), "ring" runs them edge-partitioned over a mesh
(`parallel/edge_partition.py`). The names are kept so one flag set drives both
packages.

Dead reference flags (memosize, rank, hyperNum, hyperReg, target, nfs,
deep_layer, mult, att_size, subUsrSize, subUsrDcy, divSize, graphSampleN,
slot, temp) are dropped, as in the JAX package. Per-dataset presets mirror
the four launch scripts (gowalla.sh, movielens.sh, yelp.sh, amazon.sh).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (ref: Params.py + model.py:104-205)."""

    latdim: int = 64            # embedding size (Params.py:13)
    graph_num: int = 8          # number of time-interval graphs (Params.py:10)
    gnn_layer: int = 2          # propagation hops per interval (Params.py:23)
    att_layer: int = 4          # sequence-branch attention layers (Params.py:45)
    num_heads: int = 16         # attention heads (Params.py:21)
    ssldim: int = 32            # meta-network hidden dim (Params.py:14)
    pos_length: int = 200       # max sequence length (Params.py:43)
    leaky: float = 0.5          # leaky-relu slope (Params.py:38); note the
                                # shell presets rely on the default except
                                # movielens.sh which sets it explicitly
    keep_rate: float = 0.5      # dropout keep rate (Params.py:31)
    # Parity quirks (SURVEY.md §7.0). parity=True reproduces the reference's
    # observable semantics exactly (Q1-Q6); turning it off enables the
    # "fixed" variants (stable softmax, per-token sequence attention).
    stable_softmax: bool = False    # Q5: ref uses raw exp attention
    per_token_seq_attention: bool = False  # Q3: ref pools seq to 1 token
    # Propagation backend: "xla" (plain PyTorch gather + scatter_add_),
    # "pallas" (the hand-written CUDA segment-sum, ops/spmm_cuda.py; on a
    # CPU tensor it runs the same plain version) or "ring" (the segment-
    # sum per ring bucket, K6, edge-partitioned over a mesh's 'model' axis;
    # needs Trainer(mesh=...), f32 tables only, no edge dropout or edge
    # attention). The JAX package's names are kept so one flag set drives
    # both packages.
    spmm_backend: str = "xla"
    spmm_exact: bool = True         # pallas: f32 table (parity) vs a bf16
                                    # table accumulated in f32
    spmm_chunk_size: int = 0        # JAX chunk planner only; the port's CSR
                                    # plan has no chunks and ignores it
    # source-sharded propagation for huge node tables (0 = auto, -1 = off,
    # >0 = rows per shard): each hop sums shard by shard into its output
    # (K3, "pallas" only). Auto turns it on past 32 MiB of f32 table
    # (`resolve_src_sharding`), as the JAX Trainer does.
    spmm_src_shard_rows: int = 0
    # gather through the [N/2, 2D] row-folded view of the table (K4, the
    # unweighted "pallas" hops). A TPU lane-padding lever; on the card it
    # reads the same bytes and gives the same values as the unfolded mode.
    spmm_fold_gather: bool = False
    # Q2 variant: degree-normalized propagation (DataHandler.py:50-59).
    # None = parity (unweighted); the weighted segment-sum (K2) otherwise.
    edge_norm: Optional[str] = None  # None | "sym_sqrt" | "mean"
    # Q1 variant: functional edge dropout (model.py:93-102). 1.0 = parity
    # (off). Training only; weights every hop through K2.
    edge_dropout_keep: float = 1.0
    # sequence-parallel per-token attention: ring attention over a mesh's
    # 'model' axis (needs per_token_seq_attention, a mesh whose 'model'
    # axis divides pos_length; parallel/ring_attention.py)
    seq_parallel: bool = False
    # GAT-style edge-attention propagation (SDDMM K5 + weighted SpMM K2;
    # "pallas" backend only).
    edge_attention: bool = False
    # recompute propagation activations in the backward pass (training
    # only): one checkpoint per interval, and one around the fusion stack
    # when it is not chunked
    remat_propagation: bool = False
    # run the temporal-fusion node axis in blocks of this many rows (the
    # stack is row-parallel per node): bounds the live LSTM/attention
    # temporaries at huge node counts; in training each block is
    # recomputed in the backward. 0 = unchunked.
    fusion_chunk_rows: int = 0
    # compute dtype for the temporal-fusion + sequence-attention stack:
    # "f32" | "bf16". bf16 casts the stack's inputs and parameters per
    # block (the f32 parameters stay the masters) and forces the stable
    # softmax; parity needs f32 (Q5's raw-exp attention overflows bf16).
    fusion_dtype: str = "f32"  # "f32" | "bf16"

    @property
    def head_dim(self) -> int:
        assert self.latdim % self.num_heads == 0
        return self.latdim // self.num_heads


@dataclass(frozen=True)
class TrainConfig:
    """Optimization / loop hyperparameters (ref: Params.py, model.py:241-250)."""

    lr: float = 1e-3            # Params.py:5
    batch: int = 512            # users per step (Params.py:6)
    reg: float = 1e-5           # L2 weight (Params.py:8)
    ssl_reg: float = 1e-4       # SSL loss weight (Params.py:41)
    epoch: int = 100            # Params.py:9
    decay: float = 0.96         # staircase LR decay rate (Params.py:11)
    trn_num: int = 10000        # users sampled per epoch (Params.py:24)
    samp_num: int = 40          # positives per user per step; the reference
                                # hardcodes sample_num_list=[40] (model.py:346)
    ssl_num: int = 20           # SSL pairs per user per interval (Params.py:19)
    pred_num: int = 5           # target-position randomization range (Params.py:46)
    test_size: int = 100        # candidates per test user (Params.py:18)
    tst_epoch: int = 3          # test cadence (Params.py:35)
    shoot: int = 10             # the headline K (Params.py:26)
    test_mode: bool = True      # True: test on tstInt; False: validation on
                                # last sequence item (Params.py:48, model.py:398-402)
    full_sort: bool = False     # rank the positive against the FULL catalog
                                # (minus the user's own input items) instead
                                # of the reference's 999-precomputed-negative
                                # protocol (no reference analog; the stricter
                                # standard rec-sys evaluation)
    full_sort_chunk: int = 0    # full-sort eval catalog chunking: 0 = auto
                                # (stream in 65,536-item chunks once the
                                # catalog passes 131,072 items — the dense
                                # [B, I] score matrix is ~1 GB/batch at 1M
                                # items); -1 = force dense; >0 = explicit
                                # items per chunk (streaming rank, see
                                # train.metrics.streaming_positive_ranks)
    seed: int = 100             # main.py:21-23
    save_path: str = "tem"      # Params.py:12
    load_model: Optional[str] = None
    time_budget_h: float = 0.0  # >0: stop cleanly at an epoch boundary
                                # when the NEXT epoch (predicted from the
                                # measured mean epoch time) would exceed
                                # this wall-clock budget — the run
                                # finalizes checkpoints and prints the max
                                # line instead of being killed mid-epoch
                                # (preemptible-quota surface; resume with
                                # --load_model is trajectory-exact). No
                                # reference analog.

    @property
    def decay_step(self) -> int:
        # Params.py:53: args.decay_step = trnNum // batch
        return max(1, self.trn_num // self.batch)

    @property
    def steps_per_epoch(self) -> int:
        return -(-self.trn_num // self.batch)


@dataclass(frozen=True)
class DataConfig:
    """Dataset identity and location (ref: DataHandler.py:71-102)."""

    data: str = "yelp"
    data_dir: str = "./Datasets"
    noise_percent: float = 0.0  # --percent noise-robustness mode (Params.py:42)

    @property
    def predir(self) -> str:
        # DataHandler.py:73-80 special-cases capitalized Yelp
        name = {"yelp": "Yelp"}.get(self.data, self.data)
        return f"{self.data_dir}/{name}"


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)

    @staticmethod
    def preset(name: str, **overrides) -> "Config":
        cfg = PRESETS[name]
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        return cfg


# the auto source-sharding threshold (JAX trainer.py:132-143): XLA's
# gather-operand cliff on the TPU, kept so one config resolves alike in
# both packages
SRC_SHARD_BYTES = 32 * 2 ** 20


def resolve_src_sharding(cfg: Config, num_users: int,
                         num_items: int) -> Config:
    """spmm_src_shard_rows=0 (auto) as the JAX Trainer resolves it, for the
    "pallas" backend: the largest multiple of 128 rows whose f32 table
    stays under 32 MiB when a node table is larger than that, else -1
    (off). Explicit values and other backends are returned unchanged."""
    mc = cfg.model
    if mc.spmm_backend != "pallas" or mc.spmm_src_shard_rows != 0:
        return cfg
    cliff_rows = max(128, SRC_SHARD_BYTES // (4 * mc.latdim) // 128 * 128)
    rows = cliff_rows if max(num_users, num_items) > cliff_rows else -1
    return cfg.replace(model=dataclasses.replace(mc,
                                                 spmm_src_shard_rows=rows))


# Per-dataset presets, mirroring the launch scripts verbatim.
PRESETS = {
    # gowalla.sh: --lr 2e-3 --reg 1e-2 --ssl_reg 1e-6 --epoch 150 --batch 512
    #   --sslNum 40 --graphNum 3 --gnn_layer 2 --att_layer 1 --testSize 1000
    #   --ssldim 48
    "gowalla": Config(
        model=ModelConfig(graph_num=3, gnn_layer=2, att_layer=1, ssldim=48),
        train=TrainConfig(lr=2e-3, reg=1e-2, ssl_reg=1e-6, epoch=150,
                          batch=512, ssl_num=40, test_size=1000,
                          save_path="gowalla"),
        data=DataConfig(data="gowalla"),
    ),
    # movielens.sh: --lr 1e-3 --reg 1e-2 --ssl_reg 1e-6 --sslNum 90
    #   --graphNum 6 --gnn_layer 2 --att_layer 3 --testSize 1000 --ssldim 48
    #   --keepRate 0.5 --pos_length 200 --leaky 0.5
    "movielens": Config(
        model=ModelConfig(graph_num=6, gnn_layer=2, att_layer=3, ssldim=48,
                          keep_rate=0.5, pos_length=200, leaky=0.5),
        train=TrainConfig(lr=1e-3, reg=1e-2, ssl_reg=1e-6, epoch=150,
                          batch=512, samp_num=40, ssl_num=90, test_size=1000,
                          save_path="movie6"),
        data=DataConfig(data="movielens"),
    ),
    # yelp.sh: --reg 1e-2 --ssl_reg 1e-7 --sslNum 40 --graphNum 12
    #   --gnn_layer 3 --att_layer 2 --testSize 1000 --ssldim 32 --sampNum 40
    "yelp": Config(
        model=ModelConfig(graph_num=12, gnn_layer=3, att_layer=2, ssldim=32),
        train=TrainConfig(lr=1e-3, reg=1e-2, ssl_reg=1e-7, epoch=150,
                          batch=512, samp_num=40, ssl_num=40, test_size=1000,
                          save_path="yelp12"),
        data=DataConfig(data="yelp"),
    ),
    # amazon.sh: --reg 1e-2 --lr 1e-3 --ssl_reg 1e-6 --sslNum 80 --graphNum 5
    #   --pred_num 0 --gnn_layer 3 --att_layer 4 --testSize 1000
    #   --keepRate 0.5 --sampNum 40 --pos_length 200
    "amazon": Config(
        model=ModelConfig(graph_num=5, gnn_layer=3, att_layer=4, ssldim=32,
                          keep_rate=0.5, pos_length=200),
        train=TrainConfig(lr=1e-3, reg=1e-2, ssl_reg=1e-6, epoch=150,
                          batch=512, samp_num=40, ssl_num=80, pred_num=0,
                          test_size=1000, save_path="amazon"),
        data=DataConfig(data="amazon"),
    ),
}
