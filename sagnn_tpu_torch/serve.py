"""Serving and evaluation entry point; the port of `scripts/recommend.py`
(top-k over the full catalog, from a trained checkpoint, optionally over a
sharded catalog) and of the single-process candidate evaluation in
`Trainer.test_epoch` (`sagnn_tpu/train/trainer.py`).

    python -m sagnn_tpu_torch.serve --data synthetic --preset gowalla \\
        --users 0 1 2 --k 10 [--params file.npz] [--device cpu] \\
        [--recall 0.95]
    python -m sagnn_tpu_torch.serve --data gowalla --data_dir Datasets \\
        --ckpt_root Models --save_path gowalla --users 0 1 2 \\
        [--catalog_shards 4]

prints one JSON line per user: {"user", "items", "scores"}. Without
--params or a checkpoint the weights are random, drawn from the preset's
train seed. With `--ckpt_root` / `--save_path` the model is rebuilt from
the checkpoint's config.json (written by the Trainer) and its params
restored, as `scripts/recommend.py` does (`--params` and the edge flags
are refused then: the checkpoint defines the model). `--catalog_shards
N` serves the top-k over the item encodings split across N ranks
(`parallel/serving.py`): the visible cards, or N ranks on the one card
or on the CPU. Without a checkpoint, `--edge_norm sym_sqrt|mean` serves
degree-normalised propagation and `--edge_attention` edge attention. It propagates through
the CUDA kernels on the card (the segment-sum, weighted with edge_norm,
with the SDDMM for edge attention; source-sharded past 32 MiB of node
table, as the Trainer resolves it) and through their plain versions on
the CPU. The graph is encoded once per `Recommender`; recommendations and
evaluation reuse it (eval is deterministic, keepRate=1). A config trained
on the "ring" backend is served on one device from the same weights, as
`scripts/recommend.py:67-73` does (the ring is a training layout): on the
"pallas" backend, so that the card still runs the segment-sum kernel,
where the JAX script picks its compiled "xla" path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sagnn_tpu_torch.config import PRESETS, Config, resolve_src_sharding
from sagnn_tpu_torch.data.graph import compile_interval_graphs
from sagnn_tpu_torch.data.io import DatasetBundle
from sagnn_tpu_torch.data.sampler import test_batch, user_sequences
from sagnn_tpu_torch.device import resolve_device
from sagnn_tpu_torch.models.selfgnn import (Params, SelfGNN,
                                            graphs_to_device, param_shapes)
from sagnn_tpu_torch.parallel.mesh import Mesh, make_mesh
from sagnn_tpu_torch.parallel.serving import (pad_catalog, shard_catalog,
                                              sharded_recommend_top_k)
from sagnn_tpu_torch.train.checkpoint import CheckpointManager
from sagnn_tpu_torch.train.metrics import topk_metrics


def catalog_mesh(shards: int, device: torch.device | str = "cuda") -> Mesh:
    """A ('data' 1, 'model' `shards`) mesh to shard a catalog over: the
    visible cards (as many as `shards`, or make_mesh refuses), or, on the
    CPU or with one card, `shards` ranks all on that device."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return make_mesh(data=1, model=shards, devices=["cpu"] * shards)
    if torch.cuda.device_count() == 1:
        return make_mesh(data=1, model=shards,
                         devices=[f"cuda:{dev.index or 0}"] * shards)
    return make_mesh(data=1, model=shards)


def load_checkpoint(ckpt_root: str, save_path: str,
                    default_cfg: Optional[Config] = None
                    ) -> Tuple[Config, Params]:
    """The Config and params a Trainer saved under <ckpt_root>/<save_path>:
    the model is rebuilt from its config.json, or from `default_cfg` (a
    preset) where it has none (JAX scripts/recommend.py:59-99). Raises
    FileNotFoundError, and creates nothing, when the directory, a config
    or the params are missing."""
    where = os.path.join(ckpt_root, save_path)
    if not os.path.isdir(where):
        raise FileNotFoundError(f"no checkpoint under {where}")
    ckpt = CheckpointManager(ckpt_root, save_path)
    cfg = ckpt.load_config() or default_cfg
    params = ckpt.load_params()
    if cfg is None or params is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt.dir}")
    return cfg, params


def fit_graph_num(cfg: Config, bundle: DatasetBundle) -> Config:
    """`cfg` with the bundle's interval count: a dataset's graphs win over
    the config's graph_num."""
    if bundle.graph_num == cfg.model.graph_num:
        return cfg
    return cfg.replace(model=dataclasses.replace(
        cfg.model, graph_num=bundle.graph_num))


class Recommender:
    """One model, its parameters and its dataset's graphs on one device."""

    def __init__(self, cfg: Config, bundle: DatasetBundle,
                 params: Optional[Params] = None,
                 device: torch.device | str = "cuda",
                 catalog_mesh: Optional[Mesh] = None):
        """params: the port's flat dict (`convert.py`); None draws random
        weights from a CPU `torch.Generator` seeded with cfg.train.seed, so
        every device gets the same weights. spmm_src_shard_rows=0 resolves
        as the Trainer resolves it; explicit or resolved shard rows serve
        through the source-sharded plans. catalog_mesh: serve the top-k
        over the item encodings sharded across its 'model' axis
        (`parallel.serving.sharded_recommend_top_k`); the encode and the
        queries stay on `device`."""
        self.device = resolve_device(device)
        if bundle.graph_num != cfg.model.graph_num:
            raise ValueError(f"dataset has {bundle.graph_num} interval "
                             f"graphs, config says {cfg.model.graph_num}")
        if cfg.model.spmm_backend == "ring":
            cfg = cfg.replace(model=dataclasses.replace(
                cfg.model, spmm_backend="pallas"))
        cfg = resolve_src_sharding(cfg, bundle.num_users, bundle.num_items)
        self.cfg = cfg
        self.bundle = bundle
        self.model = SelfGNN(cfg.model, bundle.num_users, bundle.num_items)
        self.graphs = graphs_to_device(
            compile_interval_graphs(bundle.sub_mats), self.device,
            cfg.model, bundle.sub_mats)
        if params is None:
            gen = torch.Generator().manual_seed(cfg.train.seed)
            params = self.model.init(gen, device=self.device)
        want = param_shapes(cfg.model, bundle.num_users, bundle.num_items)
        got = {k: tuple(v.shape) for k, v in params.items()}
        if got != want:
            diff = sorted(set(want.items()) ^ set(got.items()))
            raise ValueError(f"params do not fit the config: {diff[:6]}")
        self.params = {k: v.to(self.device, torch.float32)
                       for k, v in params.items()}
        self._encodings: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.catalog_mesh = catalog_mesh
        self._catalog: Optional[list] = None   # the sharded final_item

    @classmethod
    def from_checkpoint(cls, ckpt_root: str, save_path: str,
                        bundle: DatasetBundle,
                        device: torch.device | str = "cuda",
                        catalog_mesh: Optional[Mesh] = None
                        ) -> "Recommender":
        """The model a Trainer saved under <ckpt_root>/<save_path>, with
        its saved params (`load_checkpoint`), on the bundle's interval
        count."""
        cfg, params = load_checkpoint(ckpt_root, save_path)
        return cls(fit_graph_num(cfg, bundle), bundle, params,
                   device=device, catalog_mesh=catalog_mesh)

    def encode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encode the whole graph; returns (final_user, final_item)."""
        final_user, final_item, _, _ = self.model.encode(self.params,
                                                         self.graphs)
        self._encodings = (final_user, final_item)
        self._catalog = None
        return self._encodings

    @property
    def encodings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._encodings if self._encodings is not None \
            else self.encode()

    def recommend(self, users: Sequence[int], k: int = 10,
                  exclude_seen: bool = True, chunk_rows: int = 0,
                  recall_target: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k (scores [B, k], item ids [B, k]) for `users`, on the
        device, from each user's whole train sequence. recall_target in
        (0, 1] is the JAX package's; the port's top-k is exact at any
        value (`models.selfgnn.topk_descending`). With a catalog_mesh the
        top-k runs over the sharded catalog (sharded once per encode) and
        returns on the mesh's first device."""
        users = np.asarray(users, np.int64)
        seq, mask = user_sequences(self.bundle, users,
                                   self.cfg.model.pos_length)
        user_ids = torch.from_numpy(users).to(self.device)
        seq = torch.from_numpy(seq).to(self.device)
        mask = torch.from_numpy(mask).to(self.device)
        if self.catalog_mesh is None:
            return self.model.recommend_top_k(
                self.params, self.graphs, user_ids, seq, mask, k=k,
                exclude_seen=exclude_seen, recall_target=recall_target,
                chunk_rows=chunk_rows, encodings=self.encodings)
        final_user, final_item = self.encodings
        if self._catalog is None:
            self._catalog = shard_catalog(self.catalog_mesh, pad_catalog(
                final_item, len(self.catalog_mesh.model_devices)))
        return sharded_recommend_top_k(
            self.model, self.catalog_mesh, self.params, final_user,
            final_item, user_ids, seq, mask, k=k, exclude_seen=exclude_seen,
            recall_target=recall_target, item_table=self._catalog,
            chunk_rows=chunk_rows)

    def evaluate(self, max_users: Optional[int] = None,
                 ks=(1, 5, 10, 15, 20)) -> Dict[str, float]:
        """HR/NDCG@ks under the reference's candidate protocol (test_size-1
        precomputed negatives + the positive), averaged over the test users
        (the first `max_users` of them when given). "HR"/"NDCG" repeat the
        values at cfg.train.shoot, like `Trainer.test_epoch`."""
        tc = self.cfg.train
        ids = np.asarray(self.bundle.tst_usrs)
        if max_users is not None:
            ids = ids[:max_users]
        final_user, final_item = self.encodings
        totals: Dict[str, torch.Tensor] = {}
        for s in range(0, len(ids), tc.batch):
            user_ids, cand, _pos, seq, seq_mask, valid = test_batch(
                self.bundle, ids[s:s + tc.batch], tc.test_size,
                self.cfg.model.pos_length, test_mode=tc.test_mode)

            def dev(a):
                return torch.from_numpy(a).to(self.device)

            scores = self.model.score_with_encodings(
                self.params, final_user, final_item, dev(user_ids),
                dev(cand), dev(seq), dev(seq_mask))
            mets = topk_metrics(scores, ks=ks, valid=dev(valid))
            for key, v in mets.items():
                totals[key] = totals[key] + v if key in totals else v
        out = {key: float(v) / max(1, len(ids)) for key, v in totals.items()}
        if f"HR@{tc.shoot}" in out:
            out["HR"] = out[f"HR@{tc.shoot}"]
            out["NDCG"] = out[f"NDCG@{tc.shoot}"]
        return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data_dir", default="./Datasets")
    ap.add_argument("--preset", default="gowalla", choices=sorted(PRESETS))
    ap.add_argument("--users", type=int, nargs="+", required=True)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--include_seen", action="store_true")
    ap.add_argument("--recall", type=float, default=1.0,
                    help="top-k recall target in (0, 1] (the JAX "
                         "package's flag; the port's top-k is exact at "
                         "any value)")
    ap.add_argument("--catalog_chunk", type=int, default=0,
                    help="stream the catalog in chunks of this many items "
                         "(0 = auto: dense up to 131k items)")
    ap.add_argument("--params", default=None,
                    help="weights as an .npz in the flat layout of "
                         "sagnn_tpu_torch.convert (default: random)")
    ap.add_argument("--ckpt_root", default=None,
                    help="serve the checkpoint a Trainer saved under "
                         "<ckpt_root>/<save_path> (default ./Models when "
                         "--save_path is given)")
    ap.add_argument("--save_path", default=None,
                    help="the checkpoint's directory under --ckpt_root "
                         "(default tem when --ckpt_root is given)")
    ap.add_argument("--catalog_shards", type=int, default=0,
                    help="shard the item catalog over this many ranks "
                         "(the visible cards, or ranks on the one card or "
                         "the CPU) and merge their top-k; 0 = one device")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--synth_users", type=int, default=2048,
                    help="--data synthetic: number of users")
    ap.add_argument("--synth_items", type=int, default=4096,
                    help="--data synthetic: number of items")
    ap.add_argument("--edge_norm", choices=["sym_sqrt", "mean"],
                    help="degree-normalised propagation")
    ap.add_argument("--edge_attention", action="store_true",
                    help="edge-attention propagation")
    args = ap.parse_args(argv)
    from_ckpt = args.ckpt_root is not None or args.save_path is not None
    if from_ckpt and (args.params or args.edge_norm or args.edge_attention):
        ap.error("--params, --edge_norm and --edge_attention do not apply "
                 "to a checkpoint: its weights and config.json define the "
                 "model")

    cfg = PRESETS[args.preset]
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, spmm_backend="pallas", edge_norm=args.edge_norm,
        edge_attention=args.edge_attention))
    params = None
    if from_ckpt:
        # the checkpoint carries its training Config: the model (and a
        # synthetic bundle's seed) come from it
        try:
            cfg, params = load_checkpoint(args.ckpt_root or "./Models",
                                          args.save_path or "tem", cfg)
        except FileNotFoundError as e:
            print(e, file=sys.stderr)
            sys.exit(1)
    elif args.params:
        from sagnn_tpu_torch.convert import load_npz
        params = load_npz(args.params)
    if args.data == "synthetic":
        from sagnn_tpu_torch.data.synthetic import synthetic_dataset
        bundle = synthetic_dataset(num_users=args.synth_users,
                                   num_items=args.synth_items,
                                   graph_num=cfg.model.graph_num,
                                   test_size=cfg.train.test_size,
                                   seed=cfg.train.seed)
    else:
        from sagnn_tpu_torch.data.io import load_dataset
        bundle = load_dataset(f"{args.data_dir}/{args.data}")
    mesh = (catalog_mesh(args.catalog_shards, args.device)
            if args.catalog_shards > 1 else None)
    rec = Recommender(fit_graph_num(cfg, bundle), bundle, params,
                      device=args.device, catalog_mesh=mesh)
    scores, items = rec.recommend(args.users, k=args.k,
                                  exclude_seen=not args.include_seen,
                                  chunk_rows=args.catalog_chunk,
                                  recall_target=args.recall)
    scores, items = scores.cpu().numpy(), items.cpu().numpy()
    for i, u in enumerate(args.users):
        print(json.dumps({"user": int(u), "items": items[i].tolist(),
                          "scores": [round(float(s), 4)
                                     for s in scores[i]]}))


if __name__ == "__main__":
    main()
