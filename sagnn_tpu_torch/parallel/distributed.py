"""Sharded training over a mesh: the state laid out by the sharding rules,
the batch split over 'data', and one step; the port of
`sagnn_tpu/parallel/distributed.py`.

JAX jits its single-device step under GSPMD, which inserts the
collectives. Here one process drives the grid, as the ring does
(`parallel/mesh.py`): each data rank holds a replica of the model row and
computes the losses of its slice of the batch: through the "ring" backend
over its model row (the tables whole on the row's first device); with one
model rank, through the single-device encode on its device
(`SelfGNN.encode_with_masks`); else through the "xla" / "pallas" encode
with the node tables split over its model ranks (`SelfGNN.encode_sharded`).
Each takes every option one device takes. With seq_parallel the rank's
[B/D_data, L] sequences split once more, over L, inside its sequence
branch: ring attention over its model row. The gradients are summed over
'data' (in rank order, then over the processes of a multi-process mesh,
`parallel/launch.all_reduce_sum`) and every replica applies the one TF1
Adam update to that sum, so the replicas stay bit-equal.

The losses are the single-device step's, cut by data rank: preLoss is the
hinge sum over the whole batch's real pairs divided by their count, so
each rank divides its hinge sum by the whole batch's count (a mean of the
ranks' means would weigh a short last batch's padding); the SSL loss is a
sum and splits as it is; the weight decay counts once, on data rank 0.
The dropout draws (edge dropout, the LSTM dropout's masks) are made once
per step for the whole tables, in the single-device order, and every rank
reads its rows of them: from the caller's generator, so a mesh step equals
the single-device step on the same generator state, or handed in already
drawn (`draw_jax_step_masks` from the step's JAX key: the JAX package's
GSPMD step draws the same bits as its single-device step, since they
depend on the global shapes alone).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sagnn_tpu_torch.config import Config
from sagnn_tpu_torch.models.selfgnn import (SelfGNN, StepMasks, TrainBatch,
                                            draw_step_masks)
from sagnn_tpu_torch.parallel.launch import all_reduce_sum
from sagnn_tpu_torch.parallel.sharding import (ShardingRules, Spec,
                                               batch_shardings, gather,
                                               param_shardings, place, split)
from sagnn_tpu_torch.train.optim import AdamState, TF1Adam

Shards = Dict[str, List[torch.Tensor]]   # one data rank: key -> its shards


@dataclass
class MeshState:
    """A Trainer's state over a mesh: per local data rank, every param's
    shards (`param_shardings`: the tables' row shards on the model ranks'
    devices, every other leaf on the rank's first device) and Adam's
    moments laid out alike; the step count and the step, replicated."""

    specs: Dict[str, Spec]
    params: List[Shards]
    mu: List[Shards]
    nu: List[Shards]
    count: int = 0
    step: int = 0

    def gather(self, device: torch.device) -> Dict:
        """The single-device state {"params", "opt_state", "step"} of data
        rank 0's replica, whole on `device` (what checkpoints save): the
        params as leaves that require grad, the moments detached."""
        with torch.no_grad():
            def whole(rows):
                return {k: gather(v, self.specs[k], device).detach()
                        for k, v in rows[0].items()}

            params = {k: v.requires_grad_() for k, v in
                      whole(self.params).items()}
            return {"params": params,
                    "opt_state": AdamState(mu=whole(self.mu),
                                           nu=whole(self.nu),
                                           count=self.count),
                    "step": self.step}


def place_state(state: Dict, specs: Dict[str, Spec], mesh) -> MeshState:
    """A single-device state laid out over `mesh` by `specs`: new tensors,
    the params' shards leaves that require grad."""
    def lay(d):
        rows = [{} for _ in mesh.devices]
        for k, t in d.items():
            for row, shards in zip(rows, place(t, specs[k], mesh)):
                row[k] = shards
        return rows

    params = lay(state["params"])
    for row in params:
        for shards in row.values():
            for s in shards:
                s.requires_grad_()
    opt = state["opt_state"]
    return MeshState(specs=dict(specs), params=params, mu=lay(opt.mu),
                     nu=lay(opt.nu), count=int(opt.count),
                     step=int(state["step"]))


def init_sharded_state(rules: ShardingRules, model: SelfGNN,
                       optimizer: TF1Adam,
                       gen: Optional[torch.Generator] = None,
                       split_tables: bool = True,
                       params: Optional[Dict[str, torch.Tensor]] = None
                       ) -> MeshState:
    """`params` (drawn already, e.g. by `init_params_jax` from the init
    key, as JAX jits `model.init` under the shardings) or, without them,
    params drawn from `gen` as `SelfGNN.init` draws them on one device (the
    mesh's first), then laid out by `param_shardings`; Adam's moments zero
    in the same layout, the count 0."""
    if params is None:
        params = model.init(gen, device=rules.mesh.device)
    specs = param_shardings(rules, params, split_tables)
    return place_state({"params": params, "opt_state": optimizer.init(params),
                        "step": 0}, specs, rules.mesh)


@dataclass
class ShardedBatch:
    """A batch split over this process's data ranks: one TrainBatch per
    rank, on the rank's first device, each useq_row local to its rows; and
    the real pairs the whole batch holds in this process."""

    parts: List[TrainBatch]
    pairs: float


def shard_inputs(rules: ShardingRules, batch: TrainBatch) -> ShardedBatch:
    """`batch` (numpy arrays or tensors; a process's slice of the global
    batch on a multi-process mesh) split by `batch_shardings` over the
    mesh's local data ranks and moved to each rank's first device.
    ValueError unless the batch divides."""
    rows = rules.mesh.devices
    specs = batch_shardings(rules, batch)
    pieces = {f.name: split(getattr(batch, f.name),
                            getattr(specs, f.name), len(rows))
              for f in dataclasses.fields(batch)}
    per_rank = len(pieces["seq"][0])
    parts = []
    for d, row in enumerate(rows):
        part = TrainBatch(**{k: v[d] for k, v in pieces.items()})
        # useq_row indexes the batch's seq rows: make it the part's own
        # (a pad pair's row 0 clips to 0, its mask is 0)
        part.useq_row = (part.useq_row - d * per_rank).clip(0)
        parts.append(part.to(row[0]))
    pm = batch.pair_mask
    pairs = float(pm.sum()) if isinstance(pm, torch.Tensor) \
        else float(np.asarray(pm, np.float64).sum())
    return ShardedBatch(parts, pairs)


def _flat(row: Shards) -> Dict:
    """One rank's shards keyed (key, model rank), as the optimizer takes
    them."""
    return {(k, m): s for k, v in row.items() for m, s in enumerate(v)}


class ShardedTrainStep:
    """One training step over a mesh (module docstring); JAX
    `make_sharded_train_step`. Built by `make_sharded_train_step`.

    encode(state, d, masks): data rank d's (final_user, final_item,
    user_vec, item_vec), whole on its first device, with autograd.
    loss_and_grads(state, batch, gen, masks): the step's losses and summed
    gradients, without the update, its masks drawn from `gen` or given
    (a StepMasks for the whole tables); apply(state, grads): the update.
    __call__(state, batch, gen): the step on a TrainBatch or a
    ShardedBatch, its masks drawn from `gen`; updates `state` in place and
    returns {"loss", "preLoss", "regLoss"} as 0-d tensors on the mesh's
    first device, summed over every data rank."""

    def __init__(self, rules: ShardingRules, model: SelfGNN,
                 optimizer: TF1Adam, cfg: Config, graphs: Sequence,
                 mask_graphs: Dict):
        """graphs: per local data rank, its {"ring": ...} plans (the "ring"
        backend), else `sharding.graphs_per_row`'s: the whole graphs on
        its device with one model rank, its `TPGraphs` with more;
        mask_graphs: the graphs on the mesh's first device that the
        edge-dropout draw reads."""
        self.rules = rules
        self.mesh = rules.mesh
        self.model = model
        self.optimizer = optimizer
        self.cfg = cfg
        self.graphs = list(graphs)
        self.mask_graphs = mask_graphs
        self.ring = cfg.model.spmm_backend == "ring"
        # one model rank: every data rank runs the single-device encode
        self.whole = not self.ring and self.mesh.shape["model"] == 1
        # each data rank's model over its model row: the ring's hops and
        # seq_parallel's ring attention run over that row
        self.row_models = [SelfGNN(cfg.model, model.num_users,
                                   model.num_items, mesh=self.mesh.row(d))
                           for d in range(len(self.mesh.devices))]

    def head_params(self, state: MeshState, d: int) -> Dict:
        """Data rank d's params as one dict on its first device, for the
        losses and scoring (the tables only when they are whole there)."""
        return {k: v[0] for k, v in state.params[d].items()
                if len(v) == 1}

    def encode(self, state: MeshState, d: int,
               masks: Optional[StepMasks] = None):
        masks = masks or StepMasks()
        model = self.row_models[d]
        if self.ring or self.whole:
            return model.encode_with_masks(
                self.head_params(state, d), self.graphs[d],
                masks.to(self.mesh.devices[d][0]))
        return model.encode_sharded(state.params[d], self.graphs[d], masks)

    def _reg_loss(self, state: MeshState, d: int) -> torch.Tensor:
        """Σ ||p||² over the reg/* leaves of rank d's replica, each shard's
        part summed on its device (`reg_loss` for whole leaves)."""
        dev = self.mesh.devices[d][0]
        return sum(torch.sum(s * s).to(dev)
                   for k, v in sorted(state.params[d].items())
                   if k.startswith("reg/") for s in v)

    def loss_and_grads(self, state: MeshState, batch, gen=None,
                       masks: Optional[StepMasks] = None):
        """(totals, grads): {"loss", "preLoss", "regLoss"} summed over every
        data rank, and each param's gradient summed over 'data', laid out
        as data rank 0's shards (the same bits reach every process); the
        step without its update. The step's masks are `masks` when given
        (whole tables, every rank cuts its rows and edges), else drawn from
        `gen` (None: no dropout)."""
        tc = self.cfg.train
        mesh = self.mesh
        if not isinstance(batch, ShardedBatch):
            batch = shard_inputs(self.rules, batch)
        pairs = batch.pairs
        if mesh.process_count > 1:
            pairs = float(all_reduce_sum(
                [torch.tensor([pairs], dtype=torch.float64)])[0])
        norm = max(1.0, pairs)
        if masks is None:
            masks = draw_step_masks(self.cfg.model, self.mask_graphs,
                                    self.model.num_users,
                                    self.model.num_items, gen, mesh.device)
        dev0 = mesh.device
        stats = []
        grads: List[Shards] = []
        for d, part in enumerate(batch.parts):
            enc = self.encode(state, d, masks)
            head = self.head_params(state, d)
            hinge, ssl, _ = self.row_models[d].batch_losses(head, part,
                                                            *enc)
            pre = hinge / norm
            reg = tc.ssl_reg * ssl
            if mesh.data_offset + d == 0:
                reg = tc.reg * self._reg_loss(state, 0) + reg
            loss = pre + reg
            leaves = _flat(state.params[d])
            g = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
            rank: Shards = {}
            for (k, _), t, leaf in zip(leaves, g, leaves.values()):
                rank.setdefault(k, []).append(
                    torch.zeros_like(leaf) if t is None else t)
            grads.append(rank)
            stats.append([t.detach().to(dev0) for t in (loss, pre, reg)])
        summed = {k: [sum((grads[d][k][m].to(s.device)
                           for d in range(1, len(grads))), s)
                      for m, s in enumerate(v)]
                  for k, v in grads[0].items()}
        totals = [sum(col[1:], col[0]) for col in zip(*stats)]
        if mesh.process_count > 1:
            flat = all_reduce_sum([s for v in summed.values() for s in v]
                                  + totals)
            totals = flat[-3:]
            it = iter(flat)
            summed = {k: [next(it) for _ in v] for k, v in summed.items()}
        return dict(zip(("loss", "preLoss", "regLoss"), totals)), summed

    def apply(self, state: MeshState, summed: Shards) -> None:
        """The one TF1 Adam update of the summed gradients (laid out as
        data rank 0's shards) on every replica, in place."""
        for d in range(len(state.params)):
            self.optimizer.step(
                _flat(state.params[d]),
                {(k, m): g if d == 0 else g.to(state.params[d][k][m].device)
                 for k, v in summed.items() for m, g in enumerate(v)},
                AdamState(mu=_flat(state.mu[d]), nu=_flat(state.nu[d]),
                          count=state.count))
        state.count += 1
        state.step += 1

    def __call__(self, state: MeshState, batch, gen=None
                 ) -> Dict[str, torch.Tensor]:
        totals, summed = self.loss_and_grads(state, batch, gen)
        self.apply(state, summed)
        return totals


def make_sharded_train_step(rules: ShardingRules, model: SelfGNN,
                            optimizer: TF1Adam, cfg: Config,
                            graphs: Sequence, mask_graphs: Dict
                            ) -> ShardedTrainStep:
    """The step over `rules.mesh` (`ShardedTrainStep`)."""
    return ShardedTrainStep(rules, model, optimizer, cfg, graphs,
                            mask_graphs)
