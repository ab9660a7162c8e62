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

With `mesh=` (a `parallel.mesh.Mesh`) and spmm_backend="ring" the
propagation runs edge-partitioned over the mesh's 'model' axis, in
training and in the evaluation's encode (JAX trainer.py:124-151,
234-265): unweighted and sym_sqrt hops through K6 (its backward on the
transpose direction's plans), 'mean' through the plain ring. The ring's
bucket plans replace the COO blocks and CSR plans in `self.graphs`. The
params, the optimizer state and the fusion stack live on the mesh's first
device, so checkpoints keep the single-device format: a ring-trained
checkpoint restores into a "pallas" Trainer. Not here yet (ROADMAP Queue
A6): a mesh with data > 1, the TP shardings of the other backends
(`parallel/sharding.py`) and multi-process runs.

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
from sagnn_tpu_torch.models.selfgnn import (SelfGNN, TrainBatch, check_ported,
                                            graphs_to_device, reg_loss)
from sagnn_tpu_torch.parallel.edge_partition import ring_graphs
from sagnn_tpu_torch.train.checkpoint import CheckpointManager
from sagnn_tpu_torch.ops.chunking import auto_chunk_rows
from sagnn_tpu_torch.train.metrics import (MetricsHistory,
                                           dense_positive_ranks,
                                           metrics_from_ranks,
                                           streaming_positive_ranks,
                                           topk_metrics)
from sagnn_tpu_torch.train.optim import AdamState, TF1Adam
from sagnn_tpu_torch.utils.logger import log
from sagnn_tpu_torch.utils.profiling import StepTimer

class Trainer:
    """End-to-end trainer over one DatasetBundle on one device, or with the
    ring backend over a mesh (module docstring)."""

    def __init__(self, cfg: Config, bundle: DatasetBundle,
                 ckpt_root: str = "./Models",
                 device: torch.device | str | None = None, mesh=None,
                 sampler_backend: str = "auto"):
        """device: default "cuda", or with a mesh the mesh's first device
        (a `device` of another type than the mesh's is refused).
        sampler_backend: the `Sampler`'s ("auto", "native" or "numpy")."""
        ring = cfg.model.spmm_backend == "ring"
        if mesh is not None:
            if mesh.shape["data"] > 1:
                raise NotImplementedError(
                    f"mesh data={mesh.shape['data']}: the data-parallel "
                    "step is not ported yet: ROADMAP Queue A6")
            if not ring:
                raise NotImplementedError(
                    f"a mesh with spmm_backend={cfg.model.spmm_backend!r}:"
                    " the TP shardings (parallel/sharding.py) are not "
                    "ported yet: ROADMAP Queue A6")
            if device is not None and \
                    torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not on the mesh "
                                 f"{mesh}")
            device = mesh.device
        elif ring:
            raise ValueError("spmm_backend='ring' requires a mesh")
        self.device = resolve_device("cuda" if device is None else device)
        self.mesh = mesh
        if bundle.graph_num != cfg.model.graph_num:
            raise ValueError(f"dataset has {bundle.graph_num} interval "
                             f"graphs, config says {cfg.model.graph_num}")
        cfg = resolve_src_sharding(cfg, bundle.num_users, bundle.num_items)
        check_ported(cfg.model, train=True)
        self.cfg = cfg
        self.bundle = bundle
        self.model = SelfGNN(cfg.model, bundle.num_users, bundle.num_items,
                             mesh=mesh)
        self.graph_blocks = compile_interval_graphs(bundle.sub_mats)
        if ring:
            # the ring reads its bucket plans alone; no COO blocks or CSR
            # plans ride along (JAX trainer.py:234-265)
            norm = cfg.model.edge_norm
            self.graphs = {"ring": ring_graphs(
                self.graph_blocks, mesh,
                None if norm is None else edge_weights(
                    self.graph_blocks, bundle.sub_mats, norm))}
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
        # edges processed per step: 2 directions × gnn_layer hops × the
        # real edges summed over intervals
        self.edges_per_step = (2 * cfg.model.gnn_layer
                               * int(self.graph_blocks.edge_counts.sum()))
        # weights from a CPU generator (the same on every device); the
        # dropout generator lives on the device and is seeded from it
        init_gen = torch.Generator().manual_seed(tc.seed)
        params = self.model.init(init_gen, device=self.device)
        for v in params.values():
            v.requires_grad_(True)
        self.dropout_gen = torch.Generator(device=self.device)
        self.dropout_gen.manual_seed(
            int(torch.randint(0, 2 ** 62, (1,), generator=init_gen)))
        self.state = {"params": params,
                      "opt_state": self.optimizer.init(params), "step": 0}
        self._steps_last_epoch = 0
        self._deferring = False
        self._deferred_signal: Optional[int] = None

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

    def train_step(self, batch: TrainBatch) -> Dict[str, torch.Tensor]:
        """loss = preLoss + reg·reg_loss + ssl_reg·sslloss, its gradient,
        and one TF1 Adam update of the params in place (JAX
        `make_train_step`). `batch` holds tensors on the device. Returns
        {"loss", "preLoss", "regLoss"} as 0-d device tensors, not yet
        synchronised."""
        tc = self.cfg.train
        params = self.state["params"]
        pre, ssl, _ = self.model.train_losses(params, self.graphs, batch,
                                              self.dropout_gen)
        reg = tc.reg * reg_loss(params) + tc.ssl_reg * ssl
        loss = pre + reg
        keys = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(keys, grads)}
        # the update changes the params, Adam's moments and the step count
        # over several statements; a preemption signal that lands among
        # them is saved once they are all done
        with self._signals_deferred():
            self.optimizer.step(params, grads, self.state["opt_state"])
            self.state["step"] += 1
        return {"loss": loss.detach(), "preLoss": pre.detach(),
                "regLoss": reg.detach()}

    # -- epochs --------------------------------------------------------------

    def train_epoch(self, verbose: bool = True) -> Dict[str, float]:
        """One epoch. Batch i+1 is sampled (and copied to the device) on a
        worker thread while step i runs. Each step's losses are fetched one
        step late, so the host queues step i+1 before it waits for step i.
        Each StepTimer sample spans the queueing of step i and the fetch
        of step i-1's losses."""
        tc = self.cfg.train
        ids = self.sampler.epoch_user_ids(tc.trn_num)
        steps = -(-len(ids) // tc.batch)
        epoch_loss = epoch_pre = 0.0

        def sample(i):
            self.sample_timer.tic()
            batch = self.sampler.train_batch(
                ids[i * tc.batch:(i + 1) * tc.batch]).to(self.device)
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
        draws) and the dropout generator, with the epoch to resume at."""
        return {
            "sampler": self.sampler.rng.bit_generator.state,
            "dropout_gen": self.dropout_gen.get_state().tolist(),
            "epoch": int(next_epoch),
        }

    def restore_rng_state(self, rs: Dict) -> int:
        """Install a capture_rng_state snapshot; returns its epoch."""
        self.sampler.rng.bit_generator.state = rs["sampler"]
        self.dropout_gen.set_state(
            torch.tensor(rs["dropout_gen"], dtype=torch.uint8))
        return int(rs["epoch"])

    def throughput_stats(self) -> Dict[str, float]:
        """Step time and propagation edges/s over the last epoch's steps."""
        t = self.step_timer.windowed(self._steps_last_epoch)
        mean = t.mean
        return {
            "step_ms_mean": mean * 1e3,
            "step_ms_p50": t.percentile(50) * 1e3,
            "step_ms_p95": t.percentile(95) * 1e3,
            "edges_per_sec": (self.edges_per_step / mean
                              if t.times else 0.0),
        }

    def test_epoch(self, max_users: int | None = None,
                   full_sort: bool | None = None) -> Dict[str, float]:
        """HR/NDCG@{1,5,10,15,20} over the test users (the first
        `max_users` of them when given), under the reference's candidate
        protocol or, with full_sort (default cfg.train.full_sort), against
        the full catalog (`_full_sort_eval`). The graph is encoded once;
        batch i+1 is sampled on a thread while batch i scores, and the sums
        are fetched once at the end. debug_uid >= 0 prints that batch row's
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
        params = self.state["params"]
        final_user, final_item, _, _ = self.model.encode(params, self.graphs)

        def sample(i):
            bat = ids[i * tc.batch:(i + 1) * tc.batch]
            if full_sort:
                arrs = self.sampler.full_sort_batch(bat,
                                                    test_mode=tc.test_mode)
            else:
                user_ids, cand, _pos, seq, seq_mask, valid = \
                    self.sampler.test_batch(bat, test_mode=tc.test_mode)
                arrs = (user_ids, cand, seq, seq_mask, valid)
            return tuple(torch.from_numpy(a).to(self.device) for a in arrs)

        totals: Dict[str, torch.Tensor] = {}
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            nxt = pool.submit(sample, 0)
            for i in range(steps):
                arrs = nxt.result()
                if i + 1 < steps:
                    nxt = pool.submit(sample, i + 1)
                if full_sort:
                    mets = self._full_sort_eval(params, final_user,
                                                final_item, *arrs)
                else:
                    user_ids, cand, seq, seq_mask, valid = arrs
                    scores = self.model.score_with_encodings(
                        params, final_user, final_item, user_ids, cand, seq,
                        seq_mask)
                    if self.debug_uid >= 0:
                        print(scores[self.debug_uid].cpu().numpy())
                    mets = topk_metrics(scores, ks=(1, 5, 10, 15, 20),
                                        valid=valid)
                for k, v in mets.items():
                    totals[k] = totals[k] + v if k in totals else v
        out = {k: float(v) / max(1, num) for k, v in totals.items()}
        out["HR"] = out[f"HR@{tc.shoot}"]
        out["NDCG"] = out[f"NDCG@{tc.shoot}"]
        return out

    def _full_sort_eval(self, params, final_user, final_item, user_ids,
                        pos_items, seq, seq_mask, excl_idx, valid):
        """One full-sort batch's summed metrics (JAX
        `_full_sort_eval_impl`, trainer.py:585-612). full_sort_chunk 0
        (auto) scores densely up to DENSE_MAX_ROWS items and streams in
        AUTO_CHUNK_ROWS chunks past it; -1 forces dense, > 0 streams in
        chunks of that many items."""
        num_items = final_item.shape[0]
        chunk = self.cfg.train.full_sort_chunk
        if chunk == 0:
            chunk = auto_chunk_rows(num_items)
        queries = self.model.serving_queries(params, final_user, final_item,
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
        return max_res or final

    def _epoch_loop(self, st_epoch: int, max_ndcg: float = 0.0,
                    max_res: Optional[Dict] = None, max_epoch: int = 0):
        cfg = self.cfg
        max_res = max_res or {}
        t_loop = time.monotonic()
        epoch_times: list = []
        for ep in range(st_epoch, cfg.train.epoch):
            # time_budget_h: stop at the epoch boundary once the next epoch
            # (predicted from the measured mean) would overrun the budget
            if cfg.train.time_budget_h > 0 and epoch_times:
                spent = time.monotonic() - t_loop
                predicted = spent + float(np.mean(epoch_times))
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
            if ts["edges_per_sec"] > 0:
                log(f"  step {ts['step_ms_mean']:.1f} ms avg "
                    f"(p95 {ts['step_ms_p95']:.1f}), propagation "
                    f"{ts['edges_per_sec'] / 1e9:.4f} Gedges/s")
            if test:
                te = self.test_epoch()
                res = {"HR": te["HR"], "NDCG": te["NDCG"]}
                log(self.history.format_line("Test", ep, cfg.train.epoch,
                                             res))
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
            epoch_times.append(time.monotonic() - t_ep)
        return max_ndcg, max_res, max_epoch
