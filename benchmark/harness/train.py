"""The "train" traffic: whole epochs of `Trainer.train_epoch`.

Set-up builds one Trainer from the log and the seed's weights and drives it
through one warm-up epoch; that epoch's first CHECKED_STEPS steps are the
ones the reference follows. A wrapper around the Trainer's own
`train_step`, in place for the warm-up epoch only, records what those steps
were fed and what they did: the gradient the optimizer got in the first
step (Adam's first moment over 1 - b1), each step's change of the
parameters, and the parameters and optimizer state before each later
checked step (copied to the host). The window then runs whole epochs of
the same Trainer until `seconds` have passed.

The reference follows the program step by step: each checked step starts
from the state the program's step started from (the seed's weights and a
fresh optimizer for the first), so each step's loss and change is judged
alone. A reference left to its own trajectory parts from the program within
three steps by rounding alone: the first Adam step moves every weight by
about the learning rate, the loss jumps from about 10 to hundreds, and an
f64 reference parts from an f32 one as far as the program does.

The batches are the program's (its sampler draws them on its worker
thread): the reference cannot draw them again, so it takes them, and each
one is first checked against the log on its own (`check_batches`). The
dropout masks the reference draws itself, from the seed the benchmark gave
the Trainer's dropout generator, users' then items', as the model draws
them.
"""

from __future__ import annotations

import gc
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import counts, logs, oracle
from benchmark.harness.stages import Stages
from benchmark.harness.trace import WINDOW_SPAN
from benchmark.harness.weights import make_weights, mask_seed
from benchmark.reference import selfgnn as ref

# the steps the reference follows
CHECKED_STEPS = 3
# the Trainer's sampler: the native one, on its worker thread
SAMPLER = "native"
BATCH_FIELDS = ("uids", "pos_iids", "neg_iids", "useq_row", "pair_mask",
                "seq", "seq_mask", "ssl_u_a", "ssl_i_a", "ssl_u_b", "ssl_i_b",
                "ssl_mask")


class Program:
    """The system under test for one train run, and what set-up saw."""

    def __init__(self, cell, seed: int, device: torch.device,
                 **model_overrides):
        from sagnn_tpu_torch.train.trainer import Trainer

        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg = cell.program_config(seed, **model_overrides)
        clock = Stages()
        self.log = logs.generate(cell.log, seed)
        bundle = logs.bundle(self.log, self.cfg.model.graph_num)
        clock.mark("log")
        weights = make_weights(cell.model, self.log.num_users,
                               self.log.num_items, seed, device)
        clock.mark("weights")
        self._ckpt = tempfile.TemporaryDirectory(prefix="bench_ckpt_")
        self.trainer = Trainer(self.cfg, bundle, ckpt_root=self._ckpt.name,
                               device=device,
                               sampler_backend=SAMPLER)
        self.trainer.load_imported_params(weights)
        self.trainer.dropout_gen.manual_seed(mask_seed(seed))
        clock.mark("trainer")
        self.record = self._warm_up()
        clock.mark("warm-up epoch")
        self.stages = clock.seconds
        self.users_per_epoch = min(self.cfg.train.trn_num,
                                   self.log.num_users)

    def _warm_up(self) -> dict:
        t = self.trainer
        rec: Dict = {"batches": [], "change": [], "starts": []}
        step = t.train_step
        b1 = t.optimizer.b1
        calls = 0
        # the parameters before the latest checked step, on the host (a
        # copy on the card would raise the peak)
        before: Dict[str, torch.Tensor] = {}

        def moved():
            params = t.state["params"]
            rec["change"].append(oracle.leaf_norms(
                {k: params[k].detach() - v.to(params[k].device)
                 for k, v in before.items()}))

        def recorded_step(batch):
            nonlocal calls, before
            calls += 1
            params, opt = t.state["params"], t.state["opt_state"]
            if before:
                moved()
            if calls == 2:
                rec["grad"] = oracle.leaf_norms(
                    {k: m / (1 - b1) for k, m in opt.mu.items()})
            if calls == 1:
                before = to_host(params)
            elif calls <= CHECKED_STEPS:
                rec["starts"].append(host_state(params, opt.mu, opt.nu,
                                                opt.count))
                before = rec["starts"][-1]["params"]
            else:
                before = {}
            if calls <= CHECKED_STEPS:
                rec["batches"].append({f: getattr(batch, f).cpu().numpy()
                                       for f in BATCH_FIELDS})
            return step(batch)

        t.train_step = recorded_step
        try:
            t.train_epoch(verbose=False)
        finally:
            del t.train_step
        if before:                          # an epoch of exactly that many
            moved()
        rec["losses"] = [s["loss"] for s in t.step_stats[:CHECKED_STEPS]]
        return rec

    def window(self, seconds: float, on_device: bool,
               trace: bool = False) -> dict:
        """Whole epochs until `seconds` have passed; returns the counts."""
        t = self.trainer
        samples0 = len(t.sample_timer.times)
        sync = torch.cuda.synchronize if on_device else (lambda: None)
        sync()
        with torch.profiler.record_function(WINDOW_SPAN):
            t0 = time.perf_counter()
            ends = []
            while True:
                t.train_epoch(verbose=False)
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= seconds:
                    break
            sync()
            window_s = time.perf_counter() - t0
        epochs = len(ends)
        samples = t.sample_timer.times[samples0:]
        steps = epochs * -(-self.users_per_epoch // self.cfg.train.batch)
        return {"window_s": window_s, "epochs": epochs, "steps": steps,
                "attempted": steps,
                "rounds_s": list(np.diff([0.0] + ends)),
                "users": epochs * self.users_per_epoch,
                "sample_s": sum(samples), "samples": len(samples)}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.trainer = None
        self._ckpt.cleanup()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def end_to_end(meas: dict) -> Dict[str, float]:
    return {"train_users_per_s": meas["users"] / meas["window_s"]}


def layer_context(prog: Program, meas: dict) -> dict:
    """What the per-layer readers read besides the trace."""
    m, t = prog.cell.model, prog.cfg.train
    edges = logs.interval_edges(prog.log, m["graph_num"])
    U, I = prog.log.num_users, prog.log.num_items
    return {
        "steps": meas["steps"],
        "sample_ms": (1e3 * meas["sample_s"] / meas["samples"]
                      if meas["samples"] else None),
        "flops_per_step": counts.train_step_flops(
            m, {"batch": t.batch, "samp_num": t.samp_num,
                "ssl_num": t.ssl_num}, U, I, [e.shape[1] for e in edges]),
        "k1_bound_s_per_step": counts.k1_bound_s_per_step(
            edges, U, I, m["latdim"], m["gnn_layer"]),
    }


def to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """f32 copies on the host."""
    return {k: v.detach().to("cpu", torch.float32, copy=True)
            for k, v in tensors.items()}


def host_state(params, mu, nu, count: int) -> dict:
    """An optimizer's whole state, copied to the host in f32."""
    return {"params": to_host(params), "mu": to_host(mu), "nu": to_host(nu),
            "count": int(count)}


def reference_steps(cell, log: logs.Log, seed: int, batches: List[dict],
                    device: torch.device, dtype: torch.dtype = torch.float32,
                    starts: Optional[List[dict]] = None,
                    keep_starts: bool = False) -> dict:
    """The reference over `batches`, the dropout masks drawn from the seed:
    the first step from the seed's weights and a fresh optimizer, each
    later step n from `starts[n - 1]` (a state `host_state` copied before
    that step) where given, else from where the reference's own step left
    it. Returns each step's loss, each step's gradient norms per leaf
    ("grads"; "grad", the first's) and change of the parameters per leaf,
    and with keep_starts its own state before each later step.
    dtype: the reference's float type (float64 for a witness)."""
    m, tr = cell.model, cell.config["train"]
    U, I = log.num_users, log.num_items
    graph = ref.Graph.from_edges(logs.interval_edges(log, m["graph_num"]),
                                 U, I, device)
    model = ref.SelfGNN(m, graph)
    p = {k: v.to(dtype) for k, v in
         make_weights(m, U, I, seed, device).items()}
    for v in p.values():
        v.requires_grad_(True)
    adam = ref.TF1Adam(tr["lr"], tr["decay"], tr["trn_num"] // tr["batch"])
    gen = torch.Generator(device=device).manual_seed(mask_seed(seed))
    shape = (m["graph_num"], m["latdim"])
    out: Dict = {"losses": [], "grads": [], "change": []}
    if keep_starts:
        out["starts"] = []
    keys = sorted(p)
    for n, b in enumerate(batches):
        if n and keep_starts:
            out["starts"].append(host_state(p, adam.m, adam.v, adam.t))
        if n and starts is not None:
            s = starts[n - 1]
            with torch.no_grad():
                for k in keys:
                    p[k].copy_(s["params"][k])
            adam.m = {k: s["mu"][k].to(device, dtype, copy=True)
                      for k in keys}
            adam.v = {k: s["nu"][k].to(device, dtype, copy=True)
                      for k in keys}
            adam.t = s["count"]
        keep = None
        if m["keep_rate"] < 1.0:
            keep = tuple(torch.rand((rows, *shape), generator=gen,
                                    device=device) < m["keep_rate"]
                         for rows in (U, I))
        batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in batch.items()}
        terms = model.loss(p, batch, tr["reg"], tr["ssl_reg"], keep)
        grads = torch.autograd.grad(terms["loss"], [p[k] for k in keys],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p[k]) if g is None else g
                 for k, g in zip(keys, grads)}
        out["losses"].append(terms["loss"].item())
        out["grads"].append(oracle.leaf_norms(grads))
        del terms, keep, batch
        before = {k: v.detach().clone() for k, v in p.items()}
        adam.step(p, grads)
        del grads
        out["change"].append(oracle.leaf_norms(
            {k: p[k].detach() - before[k] for k in keys}))
        del before
    out["grad"] = out["grads"][0]
    return out


def check_batches(batches: List[dict], log: logs.Log, cell) -> int:
    """Faults in the batches the reference was fed, judged against the log
    alone: each real row's pairs are its user's (the positive the
    sequence's last item before the row's input sequence, chosen within
    pred_num of the end; negatives outside the user's train items, its
    last train item and its test item), the rows' users all distinct
    across the batches, every SSL pair an interaction of its interval."""
    m, tr = cell.model, cell.config["train"]
    I, S, L = log.num_items, tr["samp_num"], m["pos_length"]
    train_keys = np.unique(log.users[log.train] * I + log.items[log.train])
    interval = log.intervals(m["graph_num"])
    tr_keys = log.users[log.train] * I + log.items[log.train]
    k_keys = [np.unique(tr_keys[interval == k])
              for k in range(m["graph_num"])]
    tests = log.test_items()

    def member(keys, sorted_keys):
        at = np.searchsorted(sorted_keys, keys)
        at = np.minimum(at, len(sorted_keys) - 1)
        return sorted_keys[at] == keys

    faults, users = 0, []
    for b in batches:
        rows = b["seq"].shape[0]
        for i in range(rows):
            sl = slice(i * S, (i + 1) * S)
            real = b["pair_mask"][sl]
            n = int((real > 0).sum())
            if n == 0:
                faults += int(b["seq_mask"][i].any())
                continue
            u = int(b["uids"][sl][0])
            users.append(u)
            full = log.train_sequence(u)
            posset = full[:-1]
            faults += int(n != min(S, len(posset)) or not real[:n].all())
            faults += int((b["uids"][sl][:n] != u).any()
                          or (b["useq_row"][sl][:n] != i).any())
            pos = b["pos_iids"][sl][:n]
            hi = max(min(tr["pred_num"] + 1, len(posset) - 3), 1)
            fits = False
            for c in range(1, hi + 1):
                inp = posset[:-c][-L:]
                seq = np.zeros(L, np.int64)
                mask = np.zeros(L, np.float32)
                if len(inp):
                    seq[-len(inp):] = inp
                    mask[-len(inp):] = 1
                if ((pos == posset[-c]).all()
                        and (b["seq"][i] == seq).all()
                        and (b["seq_mask"][i] == mask).all()):
                    fits = True
                    break
            faults += int(not fits)
            neg = b["neg_iids"][sl][:n].astype(np.int64)
            faults += int(member(u * I + neg, train_keys).any()
                          or (neg == full[-1]).any()
                          or (neg == tests[u]).any())
        batch_users = set(int(x) for x in b["uids"][b["pair_mask"] > 0])
        for k in range(m["graph_num"]):
            ok = b["ssl_mask"][k] > 0
            for us, its in (("ssl_u_a", "ssl_i_a"), ("ssl_u_b", "ssl_i_b")):
                u = b[us][k][ok].astype(np.int64)
                it = b[its][k][ok].astype(np.int64)
                faults += int((~member(u * I + it, k_keys[k])).sum())
                faults += int(not set(u.tolist()) <= batch_users)
    faults += len(users) - len(set(users))
    return faults


def check(prog: Program, device: torch.device) -> Dict[str, float]:
    """The numbers that decide `correct` (the program's state is freed
    first)."""
    cell, log, seed, rec = prog.cell, prog.log, prog.seed, prog.record
    prog.release()
    ref.set_tf32(False)
    want = reference_steps(cell, log, seed, rec["batches"], device,
                           starts=rec["starts"])
    numbers = oracle.train_numbers(rec, want)
    numbers["batch_faults"] = check_batches(rec["batches"], log, cell)
    return numbers
