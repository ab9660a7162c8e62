"""Single-device training loop; the port of `sagnn_tpu/train/trainer.py`
(ref: Recommender.run/trainEpoch/testEpoch, model.py:41-71, 341-382,
430-482).

One step runs the full forward (propagation over every interval, the
LSTM + attention fusion over every node, the sequence branch, both
losses), the backward, and the TF1 Adam update, eagerly on one device:
the card by default, the CPU when asked. With spmm_backend="pallas" the
propagation's forward and backward both go through the CUDA kernels
(`ops/spmm_cuda`): the segment-sum (K1) unweighted, its weighted mode (K2)
with `edge_norm` or `edge_dropout_keep < 1`, K2 with the SDDMM (K5) with
`edge_attention`, and past 32 MiB of node table (or with an explicit
`spmm_src_shard_rows`) its source-sharded accumulating mode (K3), with
row-folded gathers (K4) under `spmm_fold_gather`. The edge weights, the
cross-direction permutation and the sharded plans are attached as the
JAX Trainer does (trainer.py:132-233); the edge-dropout and LSTM dropout
masks are drawn each step from the dropout generator, so checkpoints
cover them. `remat_propagation` and `fusion_chunk_rows` bound the step's
memory at the 1M-user scale.

With `mesh=` (a `parallel.mesh.Mesh`, any data × model shape) the step
runs over the mesh (`parallel/distributed.py`): each data rank holds a
replica of the model row and takes its slice of the batch, the gradients
are summed over 'data' and every replica applies the one Adam update. On
"xla" and "pallas" with one model rank every data rank runs the
single-device encode, with more the node tables are split over the model
ranks (`parallel/sharding.py`); with spmm_backend="ring" each data rank runs
the ring over its model row (JAX trainer.py:124-151, 234-265): unweighted
and sym_sqrt hops through K6 (its backward on the transpose direction's
plans), 'mean' through the plain ring, the tables whole on the row's
first device. On a mesh that spans processes (`parallel/launch.py`) each
process samples only its rows of every batch (`Sampler.train_batch_slice`,
JAX `_assemble_global_batch`, trainer.py:515-540), and the gradients, the
losses and the evaluation's metric sums are summed over the processes.
The evaluation encodes on data rank 0's row and each data rank scores its
rows of every batch. `self.state` is the single-device state on a mesh
too, gathered from data rank 0's replica when read and laid out over the
mesh when assigned, so checkpoints keep the single-device format and
restore across mesh shapes. A mesh takes every option one device takes:
with the tables split over model ranks, edge attention (K5 and the edge
softmax on each rank's own edges), source sharding (K3 per rank and
shard, resolved from the whole tables' size), remat_propagation,
fusion_chunk_rows and the bf16 stack run per rank. `seq_parallel` (with
`per_token_seq_attention`, a mesh whose 'model' axis divides pos_length)
runs the sequence branch's attention as ring attention over each data
rank's model row, in training and in the evaluation
(`parallel/ring_attention.py`). With draws="jax" a mesh, in one process
or across processes, starts from the JAX package's initial values and
trains on its masks, as one device does: each is drawn whole from JAX's
keys and every rank takes its part.

`fusion_dtype="bf16"` (the CLI's `--bf16` with a bf16 table) trains the
fusion stack and the sequence branch in bf16 from f32 master weights.
`load_imported_params` installs weights imported from a reference TF1
checkpoint (`train/import_tf1.py`), with its Adam moments and global step
when given, on either kind of Trainer.

Evaluation ranks each test user's positive among 999 precomputed
negatives (the reference's protocol) or, with `full_sort`, among the
whole catalog but the user's train row (JAX trainer.py:402-431, 585-680):
densely up to `ops.chunking.DENSE_MAX_ROWS` items, streamed over catalog
chunks past it, as `cfg.train.full_sort_chunk` says, on every backend.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from sagnn_tpu_torch.config import Config, resolve_src_sharding
from sagnn_tpu_torch.data.graph import compile_interval_graphs, edge_weights
from sagnn_tpu_torch.data.io import DatasetBundle
from sagnn_tpu_torch.data.sampler import Sampler
from sagnn_tpu_torch.device import resolve_device
from sagnn_tpu_torch.models.selfgnn import (SelfGNN, check_ported,
                                            draw_jax_step_masks,
                                            graphs_to_device, init_params_jax,
                                            reg_loss)
from sagnn_tpu_torch.parallel.distributed import (MeshState,
                                                  init_sharded_state,
                                                  make_sharded_train_step,
                                                  place_state, shard_inputs)
from sagnn_tpu_torch.parallel.edge_partition import ring_graphs_per_row
from sagnn_tpu_torch.parallel.launch import all_reduce_sum, host_batch_slice
from sagnn_tpu_torch.parallel.sharding import ShardingRules, graphs_per_row
from sagnn_tpu_torch.train.checkpoint import CheckpointManager
from sagnn_tpu_torch.ops.chunking import auto_chunk_rows
from sagnn_tpu_torch.train.metrics import (MetricsHistory,
                                           dense_positive_ranks,
                                           metrics_from_ranks,
                                           streaming_positive_ranks,
                                           topk_metrics)
from sagnn_tpu_torch.train.optim import AdamState, TF1Adam
from sagnn_tpu_torch.utils import jax_random
from sagnn_tpu_torch.utils.logger import log
from sagnn_tpu_torch.utils.profiling import StepTimer, span

DRAWS = ("torch", "jax")


class _GatheredState(dict):
    """A mesh Trainer's `state`: the gathered single-device state, whose
    key assignments (`trainer.state["params"] = ...`) lay the changed state
    out over the mesh again. Changes inside its values stay local."""

    def __init__(self, trainer: "Trainer", state: Dict):
        super().__init__(state)
        self._trainer = trainer

    def __setitem__(self, key, value) -> None:
        super().__setitem__(key, value)
        self._trainer.state = dict(self)

    def __deepcopy__(self, memo) -> Dict:
        return copy.deepcopy(dict(self), memo)


class Trainer:
    """End-to-end trainer over one DatasetBundle on one device or over a
    mesh (module docstring)."""

    def __init__(self, cfg: Config, bundle: DatasetBundle,
                 ckpt_root: str = "./Models",
                 device: torch.device | str | None = None, mesh=None,
                 sampler_backend: str = "auto", draws: str = "torch"):
        """device: default "cuda", or with a mesh the mesh's first device
        (a `device` of another type than the mesh's is refused).
        sampler_backend: the `Sampler`'s ("auto", "native" or "numpy").
        draws: where the initial values and the dropout masks come from.
        "torch" (the default): `torch.Generator`s seeded from
        cfg.train.seed. "jax": the JAX package's own draws for the same
        seed (`utils/jax_random.py`): its PRNGKey split into the init key
        (trainer.py:274, 289), its `init_params` draw for draw
        (`init_params_jax`), and each step's masks from the key split off
        the trainer's key (trainer.py:497, `draw_jax_step_masks`), so a
        run trains from JAX's initial values and masks. On a mesh, in one
        process or across processes, the same: JAX's mesh Trainer draws
        the bits of its single-device Trainer (they depend on the global
        shapes alone), so the params are drawn whole on the mesh's first
        device and laid out, and each step's masks are drawn whole there
        and every rank takes its rows and edges of them (every process
        draws them alike from the same key). The edge masks are drawn at
        the padded [g, E] shape, so they are JAX's for a JAX Trainer run
        at its default pad_multiple, 512, the padding used here."""
        if draws not in DRAWS:
            raise ValueError(f"draws={draws!r}: one of {DRAWS}")
        self.draws = draws
        ring = cfg.model.spmm_backend == "ring"
        if mesh is not None:
            if device is not None and \
                    torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not on the mesh "
                                 f"{mesh}")
            device = mesh.device
            if cfg.train.batch % mesh.shape["data"]:
                raise ValueError(f"batch {cfg.train.batch} does not split "
                                 f"over {mesh.shape['data']} data ranks")
        elif ring:
            raise ValueError("spmm_backend='ring' requires a mesh")
        self.device = resolve_device("cuda" if device is None else device)
        self.mesh = mesh
        if bundle.graph_num != cfg.model.graph_num:
            raise ValueError(f"dataset has {bundle.graph_num} interval "
                             f"graphs, config says {cfg.model.graph_num}")
        # auto source sharding from the whole tables' size, on a mesh too
        # (JAX trainer.py:132-143)
        cfg = resolve_src_sharding(cfg, bundle.num_users, bundle.num_items)
        check_ported(cfg.model, train=True, mesh=mesh)
        self.cfg = cfg
        self.bundle = bundle
        self.model = SelfGNN(cfg.model, bundle.num_users, bundle.num_items,
                             mesh=None if mesh is None else mesh.row(0))
        self.graph_blocks = compile_interval_graphs(bundle.sub_mats)
        if ring:
            # the ring reads its bucket plans alone; no COO blocks or CSR
            # plans ride along (JAX trainer.py:234-265); one set per data
            # rank, on its model row
            norm = cfg.model.edge_norm
            rows = ring_graphs_per_row(
                self.graph_blocks, mesh,
                None if norm is None else edge_weights(
                    self.graph_blocks, bundle.sub_mats, norm))
            self.graphs = rows[0]
        else:
            self.graphs = graphs_to_device(self.graph_blocks, self.device,
                                           cfg.model, bundle.sub_mats)
        tc = cfg.train
        self.sampler = Sampler(bundle, batch=tc.batch, samp_num=tc.samp_num,
                               ssl_num=tc.ssl_num, pred_num=tc.pred_num,
                               pos_length=cfg.model.pos_length,
                               test_size=tc.test_size, seed=tc.seed,
                               backend=sampler_backend)
        self.optimizer = TF1Adam(tc.lr, tc.decay, tc.decay_step)
        self.ckpt = CheckpointManager(ckpt_root, tc.save_path)
        self.history = MetricsHistory()
        self.step_timer = StepTimer()
        self.sample_timer = StepTimer()   # host sampling per batch
        self.step_stats: list = []        # the last epoch's per-step losses
        self.debug_uid = -1
        # weights from a CPU generator (the same on every device); the
        # dropout generator lives on the device and is seeded from it
        init_gen = torch.Generator().manual_seed(tc.seed)
        self._mesh_state: Optional[MeshState] = None
        # JAX's key stream (draws="jax"): the seed's key, less the init key
        self.rng: Optional[torch.Tensor] = None
        if draws == "jax":
            self.rng, init_key = jax_random.split(
                jax_random.prng_key(tc.seed))
            params = init_params_jax(init_key, cfg.model, bundle.num_users,
                                     bundle.num_items, device=self.device)
        if mesh is None:
            if draws == "torch":
                params = self.model.init(init_gen, device=self.device)
            for v in params.values():
                v.requires_grad_(True)
            self._state = {"params": params,
                           "opt_state": self.optimizer.init(params),
                           "step": 0}
        else:
            rules = ShardingRules(mesh)
            self._mesh_state = init_sharded_state(
                rules, self.model, self.optimizer, init_gen,
                split_tables=not ring,
                params=params if draws == "jax" else None)
            if ring:
                step_graphs, mask_graphs = rows, {}
            else:
                step_graphs = graphs_per_row(self.graphs, mesh,
                                             bundle.num_users,
                                             bundle.num_items)
                mask_graphs = self.graphs
            self._mesh_step = make_sharded_train_step(
                rules, self.model, self.optimizer, cfg, step_graphs,
                mask_graphs)
        self.dropout_gen = torch.Generator(device=self.device)
        self.dropout_gen.manual_seed(
            int(torch.randint(0, 2 ** 62, (1,), generator=init_gen)))
        self._steps_last_epoch = 0
        # per epoch of `run`: its Train and Test values, its seconds, its
        # test's, the step's wall ms, the device's peak GB and the steps'
        # losses; written to the checkpoint directory's epochs.json
        self.epoch_records: list = []
        self._deferring = False
        self._deferred_signal: Optional[int] = None

    @property
    def state(self) -> Dict:
        """{"params", "opt_state", "step"} on the Trainer's device. On a mesh
        a gathered copy of data rank 0's replica (module docstring):
        assigning a state, or one of its keys, lays it out over the mesh."""
        if self._mesh_state is None:
            return self._state
        return _GatheredState(self, self._mesh_state.gather(self.device))

    @state.setter
    def state(self, value: Dict) -> None:
        if self.mesh is None:
            self._state = value
        else:
            self._mesh_state = place_state(value, self._mesh_state.specs,
                                           self.mesh)

    @property
    def mesh_state(self) -> Optional[MeshState]:
        """The state as the mesh holds it (None without a mesh)."""
        return self._mesh_state

    def load_imported_params(self, params: Dict[str, torch.Tensor],
                             mu: Optional[Dict[str, torch.Tensor]] = None,
                             nu: Optional[Dict[str, torch.Tensor]] = None,
                             step: int = 0) -> None:
        """Install imported weights (e.g. a reference TF1 Saver checkpoint
        through `train.import_tf1`) in place of the initial ones (JAX
        trainer.py:332-394). With mu/nu/step (Adam's moments and the
        saved global step) the TF1-Adam state is rebuilt, so training
        continues where the reference run stopped: the bias corrections and
        the staircase decay count from `step`. Without them Adam restarts
        at count 0; the step counter is `step` either way, as in JAX.
        Every tensor must have its parameter's key and shape."""
        old = self.state["params"]

        def check(new: Dict[str, torch.Tensor], what: str) -> None:
            if set(new) != set(old):
                diff = sorted(set(new) ^ set(old))
                raise ValueError(f"imported {what} keys differ from the "
                                 f"model's: {diff[:6]}")
            for k, v in new.items():
                if tuple(v.shape) != tuple(old[k].shape):
                    raise ValueError(f"imported {what} {k} shape "
                                     f"{tuple(v.shape)} != model "
                                     f"{tuple(old[k].shape)}")

        def put(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            return {k: torch.as_tensor(tree[k]).to(self.device, torch.float32)
                    for k in old}

        check(params, "param")
        if (mu is None) != (nu is None):
            raise ValueError("mu and nu must be given together (Adam's "
                             "first and second moments)")
        new = put(params)
        for v in new.values():
            v.requires_grad_(True)
        if mu is None:
            opt_state = self.optimizer.init(new)
        else:
            check(mu, "mu")
            check(nu, "nu")
            opt_state = AdamState(mu=put(mu), nu=put(nu), count=int(step))
        self.state = {"params": new, "opt_state": opt_state,
                      "step": int(step)}

    # -- one step ------------------------------------------------------------

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """loss = preLoss + reg·reg_loss + ssl_reg·sslloss, its gradient,
        and one TF1 Adam update of the params in place (JAX
        `make_train_step`). `batch` holds tensors on the device; on a mesh
        any TrainBatch (this process's rows of the global batch) or one
        already split (`parallel.distributed.shard_inputs`). Returns
        {"loss", "preLoss", "regLoss"} (regLoss = reg·L2 + ssl_reg·SSL) as
        0-d device tensors, not yet synchronised, and on one device
        "sslLoss", the unweighted SSL hinge."""
        with span("sagnn.train.step"):
            masks = None
            if self.draws == "jax":
                self.rng, key = jax_random.split(self.rng)
                masks = draw_jax_step_masks(
                    self.cfg.model, self.graphs if self.mesh is None
                    else self._mesh_step.mask_graphs, self.bundle.num_users,
                    self.bundle.num_items, key, self.device)
            if self._mesh_state is not None:
                totals, grads = self._mesh_step.loss_and_grads(
                    self._mesh_state, batch, self.dropout_gen, masks)
                # the update changes every replica's params and moments; a
                # preemption signal that lands meanwhile is saved after it
                with self._signals_deferred():
                    self._mesh_step.apply(self._mesh_state, grads)
                return totals
            tc = self.cfg.train
            params = self.state["params"]
            pre, ssl, _ = self.model.train_losses(params, self.graphs, batch,
                                                  self.dropout_gen, masks)
            with span("sagnn.model.losses"):
                reg = tc.reg * reg_loss(params) + tc.ssl_reg * ssl
                loss = pre + reg
            keys = list(params)
            with span("sagnn.train.backward"):
                grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                            allow_unused=True)
                grads = {k: torch.zeros_like(params[k]) if g is None else g
                         for k, g in zip(keys, grads)}
            # the update changes the params, Adam's moments and the step
            # count over several statements; a preemption signal that
            # lands among them is saved once they are all done
            with self._signals_deferred(), span("sagnn.train.optimizer"):
                self.optimizer.step(params, grads, self.state["opt_state"])
                self.state["step"] += 1
            return {"loss": loss.detach(), "preLoss": pre.detach(),
                    "regLoss": reg.detach(), "sslLoss": ssl.detach()}

    def _batch_rows(self) -> tuple:
        """(start, size): this process's rows of every batch (all of them
        but on a mesh that spans processes)."""
        if self.mesh is None or self.mesh.process_count == 1:
            return 0, self.cfg.train.batch
        return host_batch_slice(self.cfg.train.batch)

    # -- epochs --------------------------------------------------------------

    def train_epoch(self, verbose: bool = True) -> Dict[str, float]:
        """One epoch. Batch i+1 is sampled (and copied to the device, or
        split over the mesh's data ranks) on a worker thread while step i
        runs; on a mesh that spans processes only this process's rows are
        sampled. Each step's losses are fetched one step late, so the host
        queues step i+1 before it waits for step i. Each StepTimer sample
        spans the queueing of step i and the fetch of step i-1's
        losses."""
        with span("sagnn.train.epoch"):
            tc = self.cfg.train
            ids = self.sampler.epoch_user_ids(tc.trn_num)
            steps = -(-len(ids) // tc.batch)
            epoch_loss = epoch_pre = 0.0
            start, size = self._batch_rows()

            def sample(i):
                self.sample_timer.tic()
                bat = ids[i * tc.batch:(i + 1) * tc.batch]
                if self.mesh is None:
                    batch = self.sampler.train_batch(bat).to(self.device)
                else:
                    batch = shard_inputs(
                        self._mesh_step.rules,
                        self.sampler.train_batch_slice(bat, start, size))
                self.sample_timer.toc()
                return batch

            def consume(i, pending):
                nonlocal epoch_loss, epoch_pre
                stats = {k: float(v) for k, v in pending.items()}
                self.step_stats.append(stats)
                epoch_loss += stats["loss"]
                epoch_pre += stats["preLoss"]
                if verbose:
                    log(f"Step {i}/{steps}: preloss = {stats['preLoss']:.2f}, "
                        f"REGLoss = {stats['regLoss']:.2f}         ",
                        oneline=True)

            pending = None
            self._steps_last_epoch = steps
            self.step_stats = []
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                nxt = pool.submit(sample, 0)
                for i in range(steps):
                    with span("sagnn.train.wait_batch"):
                        batch = nxt.result()
                    if i + 1 < steps:
                        nxt = pool.submit(sample, i + 1)
                    self.step_timer.tic()
                    stats = self.train_step(batch)
                    # a sample with no pending fetch would time the queueing
                    # alone; the first step's toc is skipped
                    if pending is not None:
                        consume(i - 1, pending)
                        self.step_timer.toc()
                    pending = stats
                if pending is not None:
                    self.step_timer.tic()
                    consume(steps - 1, pending)
                    self.step_timer.toc()
            return {"Loss": epoch_loss / steps, "preLoss": epoch_pre / steps}

    # -- trajectory-exact resume ----------------------------------------------

    def capture_rng_state(self, next_epoch: int) -> Dict:
        """JSON-able snapshot of every RNG the trajectory depends on: the
        sampler's bit generator (epoch permutations, batch seeds, SSL
        draws) and the dropout generator, or with draws="jax" the JAX key
        under JAX's own field name (trainer.py:545-560), with the epoch to
        resume at."""
        rs = {"sampler": self.sampler.rng.bit_generator.state}
        if self.draws == "jax":
            rs["jax_key"] = self.rng.tolist()
        else:
            rs["dropout_gen"] = self.dropout_gen.get_state().tolist()
        rs["epoch"] = int(next_epoch)
        return rs

    def restore_rng_state(self, rs: Dict) -> int:
        """Install a capture_rng_state snapshot; returns its epoch. A
        snapshot of the other kind of draws is refused."""
        field = "jax_key" if self.draws == "jax" else "dropout_gen"
        if field not in rs:
            raise ValueError(f"the RNG snapshot has no {field!r}: it was "
                             f"not taken with draws={self.draws!r}")
        self.sampler.rng.bit_generator.state = rs["sampler"]
        if self.draws == "jax":
            self.rng = torch.tensor(rs["jax_key"], dtype=torch.int64)
        else:
            self.dropout_gen.set_state(
                torch.tensor(rs["dropout_gen"], dtype=torch.uint8))
        return int(rs["epoch"])

    def throughput_stats(self) -> Dict[str, float]:
        """Step time over the last epoch's steps."""
        t = self.step_timer.windowed(self._steps_last_epoch)
        return {
            "step_ms_mean": t.mean * 1e3,
            "step_ms_p50": t.percentile(50) * 1e3,
            "step_ms_p95": t.percentile(95) * 1e3,
        }

    def test_epoch(self, max_users: int | None = None,
                   full_sort: bool | None = None) -> Dict[str, float]:
        """HR/NDCG@{1,5,10,15,20} over the test users (the first
        `max_users` of them when given), under the reference's candidate
        protocol or, with full_sort (default cfg.train.full_sort), against
        the full catalog (`_full_sort_eval`). The graph is encoded once;
        batch i+1 is sampled on a thread while batch i scores, and the sums
        are fetched once at the end. On a mesh data rank 0's row encodes
        and each data rank scores its rows of every batch (this process's
        rows of it, the sums then added over the processes; JAX
        trainer.py:585-625). debug_uid >= 0 prints that batch row's
        candidate scores (the reference's --uid debug mode,
        model.py:460-461; candidate protocol only)."""
        tc = self.cfg.train
        if full_sort is None:
            full_sort = tc.full_sort
        ids = np.asarray(self.bundle.tst_usrs)
        if max_users is not None:
            ids = ids[:max_users]
        num = len(ids)
        steps = -(-num // tc.batch)
        start, size = self._batch_rows()
        ranks = self._eval_ranks()
        per_rank = size // len(ranks)

        def sample(i):
            bat = ids[i * tc.batch:(i + 1) * tc.batch][start:start + size]
            if full_sort:
                arrs = self.sampler.full_sort_batch(
                    bat, test_mode=tc.test_mode, batch_cap=size)
            else:
                user_ids, cand, _pos, seq, seq_mask, valid = \
                    self.sampler.test_batch(bat, test_mode=tc.test_mode,
                                            batch_cap=size)
                arrs = (user_ids, cand, seq, seq_mask, valid)
            return [tuple(torch.from_numpy(a[d * per_rank:
                                             (d + 1) * per_rank]).to(dev)
                          for a in arrs)
                    for d, (dev, _, _, _, _) in enumerate(ranks)]

        totals: Dict[str, torch.Tensor] = {}
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            nxt = pool.submit(sample, 0)
            for i in range(steps):
                parts = nxt.result()
                if i + 1 < steps:
                    nxt = pool.submit(sample, i + 1)
                for d, ((_, model, params, final_user, final_item), arrs) \
                        in enumerate(zip(ranks, parts)):
                    if full_sort:
                        mets = self._full_sort_eval(model, params,
                                                    final_user, final_item,
                                                    *arrs)
                    else:
                        user_ids, cand, seq, seq_mask, valid = arrs
                        scores = model.score_with_encodings(
                            params, final_user, final_item, user_ids, cand,
                            seq, seq_mask)
                        if 0 <= self.debug_uid - d * per_rank < per_rank:
                            print(scores[self.debug_uid - d * per_rank]
                                  .cpu().numpy())
                        mets = topk_metrics(scores, ks=(1, 5, 10, 15, 20),
                                            valid=valid)
                    for k, v in mets.items():
                        v = v.to(self.device)
                        totals[k] = totals[k] + v if k in totals else v
        keys = sorted(totals)
        sums = all_reduce_sum([totals[k] for k in keys]) \
            if self.mesh is not None else [totals[k] for k in keys]
        out = {k: float(v) / max(1, num) for k, v in zip(keys, sums)}
        out["HR"] = out[f"HR@{tc.shoot}"]
        out["NDCG"] = out[f"NDCG@{tc.shoot}"]
        return out

    def _eval_ranks(self) -> list:
        """(device, model, params, final_user, final_item) of each data rank
        that scores: the Trainer's device alone without a mesh; on a mesh
        every local data rank, its first device, its model over its model
        row (seq_parallel's ring attention runs there), its replica's
        params and data rank 0's encodings copied there."""
        if self.mesh is None:
            params = self.state["params"]
            fu, fi, _, _ = self.model.encode(params, self.graphs)
            return [(self.device, self.model, params, fu, fi)]
        st, step = self._mesh_state, self._mesh_step
        with torch.no_grad():
            fu, fi, _, _ = step.encode(st, 0)
        return [(row[0], step.row_models[d], step.head_params(st, d),
                 fu.to(row[0]), fi.to(row[0]))
                for d, row in enumerate(self.mesh.devices)]

    def _full_sort_eval(self, model, params, final_user, final_item,
                        user_ids, pos_items, seq, seq_mask, excl_idx,
                        valid):
        """One full-sort batch's summed metrics (JAX
        `_full_sort_eval_impl`, trainer.py:585-612). full_sort_chunk 0
        (auto) scores densely up to DENSE_MAX_ROWS items and streams in
        AUTO_CHUNK_ROWS chunks past it; -1 forces dense, > 0 streams in
        chunks of that many items."""
        num_items = final_item.shape[0]
        chunk = self.cfg.train.full_sort_chunk
        if chunk == 0:
            chunk = auto_chunk_rows(num_items)
        queries = model.serving_queries(params, final_user, final_item,
                                        user_ids, seq, seq_mask)
        if chunk > 0:
            ranks = streaming_positive_ranks(queries, final_item, pos_items,
                                             excl_idx, num_items,
                                             chunk_items=chunk)
        else:
            ranks = dense_positive_ranks(queries, final_item, pos_items,
                                         excl_idx)
        return metrics_from_ranks(ranks, valid=valid, ks=(1, 5, 10, 15, 20))

    # -- full run (ref model.py:41-71) ------------------------------------------

    @contextlib.contextmanager
    def _signals_deferred(self):
        """A preemption signal that lands inside the block is handled when
        the block ends (install_preemption_handler)."""
        self._deferring = True
        try:
            yield
        finally:
            self._deferring = False
        if self._deferred_signal is not None:
            signum, self._deferred_signal = self._deferred_signal, None
            self._preempt(signum)

    def _checkpoint(self, rng_state: Dict) -> None:
        """The best-NDCG save, whole whatever signal lands during it."""
        with self._signals_deferred():
            self.ckpt.save(self.state, self.history, self.cfg, block=False,
                           rng_state=rng_state)

    def _preempt(self, signum: int) -> None:
        """Save a checkpoint and exit with 128 + signum."""
        log(f"signal {signum}: writing preemption checkpoint")
        self._deferring = True   # a second signal must not re-enter the save
        # the RNG snapshot from the START of the epoch in progress: resume
        # re-enters that epoch drawing the same batches (params are from
        # the moment of the signal, so a mid-epoch kill resumes safely but
        # not bit-exactly)
        self.ckpt.save(self.state, self.history, self.cfg,
                       rng_state=getattr(self, "_epoch_rng_snapshot", None))
        raise SystemExit(128 + signum)

    def install_preemption_handler(self) -> Dict:
        """Save a checkpoint on SIGTERM/SIGINT before exiting. Returns the
        handlers it replaced (run() puts them back when it ends).

        A signal that lands inside the optimizer update (`train_step`) is
        saved when the update ends: the update changes the params, Adam's
        moments and the step count in place over several statements, and
        a save among them would mix two steps' state (JAX's jitted step
        swaps the whole state at once). One that lands inside a checkpoint
        save is handled when that save has committed: a second save
        started inside the first writes the same staging files, which the
        first then finishes over the committed checkpoint. Anywhere else
        the save is made at once, without waiting for the step in
        progress."""
        def _handler(signum, _frame):
            if self._deferring:
                self._deferred_signal = signum
                return
            self._preempt(signum)

        return {s: signal.signal(s, _handler)
                for s in (signal.SIGTERM, signal.SIGINT)}

    def run(self, resume: bool = False) -> Dict[str, float]:
        """Train cfg.train.epoch epochs (from the checkpoint when resuming),
        test every tst_epoch with a best-NDCG save, then evaluate the last
        epoch's params and log the Test and max lines. Returns the best
        test result (the final one when no test ran)."""
        previous = self.install_preemption_handler()
        try:
            return self._run(resume)
        finally:
            for s, h in previous.items():
                signal.signal(s, h)

    def restore_checkpoint(self) -> Optional[int]:
        """Load the saved state, history and RNG snapshot; returns the epoch
        to resume at (None when nothing was saved)."""
        state, hist = self.ckpt.restore(self.state)
        if state is None:
            return None
        self.state = state
        self.history = hist
        st_epoch = self.ckpt.resume_epoch(hist, self.cfg.train.tst_epoch)
        rs = self.ckpt.load_rng()
        if rs is not None:
            st_epoch = self.restore_rng_state(rs)
        log(f"Model Loaded, resuming at epoch {st_epoch}")
        return st_epoch

    def _run(self, resume: bool) -> Dict[str, float]:
        cfg = self.cfg
        st_epoch = 0
        if resume or cfg.train.load_model:
            st_epoch = self.restore_checkpoint() or 0

        # the best-NDCG tracker starts from the restored history, so a
        # resumed run keeps what the uninterrupted run would have kept
        max_ndcg, max_res, max_epoch = 0.0, {}, 0
        ndcgs = self.history.data.get("TestNDCG", [])
        if ndcgs:
            i = int(np.argmax(ndcgs))
            max_ndcg = float(ndcgs[i])
            max_res = {"HR": float(self.history.data["TestHR"][i]),
                       "NDCG": max_ndcg}
            max_epoch = i * cfg.train.tst_epoch
        # a resumed run keeps the records of the epochs it does not repeat
        self.epoch_records = [
            r for r in self.ckpt.load_epochs().get("epochs", [])
            if r["epoch"] < st_epoch] if st_epoch else []
        try:
            max_ndcg, max_res, max_epoch = self._epoch_loop(
                st_epoch, max_ndcg, max_res, max_epoch)
        finally:
            self.ckpt.finalize()
        final = self.test_epoch()
        log(self.history.format_line("Test", cfg.train.epoch,
                                     cfg.train.epoch,
                                     {"HR": final["HR"],
                                      "NDCG": final["NDCG"]}))
        log(self.history.format_line("max", max_epoch, cfg.train.epoch,
                                     max_res))
        self.ckpt.save_epochs({
            "epochs": self.epoch_records,
            "final": {"HR": final["HR"], "NDCG": final["NDCG"],
                      "epoch": cfg.train.epoch},
            "max": {"HR": max_res.get("HR"), "NDCG": max_res.get("NDCG"),
                    "epoch": max_epoch}})
        return max_res or final

    def _epoch_loop(self, st_epoch: int, max_ndcg: float = 0.0,
                    max_res: Optional[Dict] = None, max_epoch: int = 0):
        cfg = self.cfg
        max_res = max_res or {}
        t_loop = time.monotonic()
        for ep in range(st_epoch, cfg.train.epoch):
            # time_budget_h: stop at the epoch boundary once the next epoch
            # (predicted from this run's mean) would overrun the budget
            ran = [r["epoch_s"] for r in self.epoch_records
                   if r["epoch"] >= st_epoch]
            if cfg.train.time_budget_h > 0 and ran:
                spent = time.monotonic() - t_loop
                predicted = spent + float(np.mean(ran))
                if predicted > cfg.train.time_budget_h * 3600.0:
                    log(f"time budget: {spent / 3600.0:.2f}h spent, next "
                        f"epoch predicted to end at "
                        f"{predicted / 3600.0:.2f}h > budget "
                        f"{cfg.train.time_budget_h}h; stopping cleanly "
                        f"at epoch {ep}")
                    break
            t_ep = time.monotonic()
            test = ep % cfg.train.tst_epoch == 0
            self._epoch_rng_snapshot = self.capture_rng_state(ep)
            tr = self.train_epoch()
            # a non-finite epoch loss rolls back to the last checkpoint
            # (without its RNG state: the retry draws other batches)
            if not np.isfinite(tr["Loss"]):
                state, hist = self.ckpt.restore(self.state)
                if state is not None:
                    self.state = state
                    self.history = hist
                    log(f"NaN guard: non-finite loss at epoch {ep}; "
                        f"restored last checkpoint and continuing")
                    continue
                raise FloatingPointError(
                    f"non-finite loss at epoch {ep} with no checkpoint to "
                    f"restore")
            log(self.history.format_line("Train", ep, cfg.train.epoch, tr))
            ts = self.throughput_stats()
            if ts["step_ms_mean"] > 0:
                log(f"  step {ts['step_ms_mean']:.1f} ms avg "
                    f"(p95 {ts['step_ms_p95']:.1f})")
            t_test = time.monotonic()
            if test:
                te = self.test_epoch()
                res = {"HR": te["HR"], "NDCG": te["NDCG"]}
                log(self.history.format_line("Test", ep, cfg.train.epoch,
                                             res))
            now = time.monotonic()
            rec = dict(tr, **(res if test else {}), epoch=ep,
                       epoch_s=now - t_ep, test_s=now - t_test,
                       step_ms=ts["step_ms_mean"],
                       step_ms_p95=ts["step_ms_p95"], steps=self.step_stats)
            line = (f"  epoch {rec['epoch_s']:.3f} s (test "
                    f"{rec['test_s']:.3f} s)")
            if self.device.type == "cuda":
                rec["peak_gb"] = torch.cuda.max_memory_allocated(
                    self.device) / 1e9
                line += f", peak {rec['peak_gb']:.2f} GB"
            log(line)
            # the epoch enters the history and the resume point moves past
            # it together: a preemption checkpoint then never holds an
            # epoch that its resume runs again
            with self._signals_deferred():
                self.history.append("Train", tr)
                if test:
                    self.history.append("Test", res)
                self._epoch_rng_snapshot = self.capture_rng_state(ep + 1)
            if test and te["NDCG"] > max_ndcg:  # best-NDCG save policy
                self._checkpoint(self.capture_rng_state(ep + 1))
                max_ndcg, max_res, max_epoch = te["NDCG"], te, ep
            self.epoch_records.append(rec)
            self.ckpt.save_epochs({"epochs": self.epoch_records})
        return max_ndcg, max_res, max_epoch
