"""The "train_seq" traffic: the "train" traffic (`harness/train.py`) of a
configuration whose sequence branch attends per token
(`per_token_seq_attention`), judged against the per-token reference
(`reference/selfgnn_seq.py`).

Set-up, the window, the record of the checked steps and the batches'
check are `train.py`'s. The window also reads the program's count of the
per-token attention's rows (`ops.attention.SEQ_ATTENTION`, where the
program has it) over the window. `layer_context` gives the train readers
what `train.layer_context` gives them, under kind "train", with the
step's FLOPs counting the per-token branch (`counts_seq`), and the
per-token attention's rows and least time a row for
`seq_attention_roofline.train`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import counts_seq, logs, oracle, train
from benchmark.harness.train import host_state
from benchmark.harness.weights import make_weights, mask_seed
from benchmark.reference import selfgnn as ref
from benchmark.reference.selfgnn_seq import SelfGNNSeq

# the window's users/s, as the "train" traffic's
end_to_end = train.end_to_end


def _seq_counter() -> Optional[dict]:
    """The program's per-token attention counter; None where the program
    has none."""
    from sagnn_tpu_torch.ops import attention
    return getattr(attention, "SEQ_ATTENTION", None)


class Program(train.Program):
    def window(self, seconds: float, on_device: bool,
               trace: bool = False) -> dict:
        counter = _seq_counter()
        before = None if counter is None else dict(counter)
        meas = super().window(seconds, on_device, trace)
        if counter is not None:
            meas["seq_rows"] = counter["calls"] - before["calls"]
        return meas


def layer_context(prog: Program, meas: dict) -> dict:
    """`train.layer_context`'s keys, "flops_per_step" counting the
    per-token branch, and "seq_rows" (the window's rows of per-token
    attention, None where the program does not count them) with
    "seq_bound_s_per_row" (a row's least time, forward and backward)."""
    ctx = train.layer_context(prog, meas)
    m, t = prog.cell.model, prog.cfg.train
    tokens, pairs = row_fill(prog)
    edges = logs.interval_edges(prog.log, m["graph_num"])
    ctx["flops_per_step"] = counts_seq.train_step_flops(
        m, {"batch": t.batch, "samp_num": t.samp_num, "ssl_num": t.ssl_num},
        prog.log.num_users, prog.log.num_items, [e.shape[1] for e in edges],
        t.batch * tokens, t.batch * pairs)
    ctx["seq_rows"] = meas.get("seq_rows")
    ctx["seq_bound_s_per_row"] = counts_seq.seq_attention_bound_s(
        m["latdim"], tokens, pairs)
    ctx["kind"] = "train"
    return ctx


def row_fill(prog: Program):
    """(valid tokens, valid pairs) of a batch row on average over an
    epoch: a user's expected window fill times the share of an epoch's
    rows that hold a user."""
    t = prog.cfg.train
    lengths = np.diff(prog.log.bounds) - 1      # each user's train items
    tokens, pairs = counts_seq.window_fill(lengths, prog.cell.model[
        "pos_length"], t.pred_num)
    rows = -(-prog.users_per_epoch // t.batch) * t.batch
    share = prog.users_per_epoch / rows
    return share * tokens, share * pairs


def reference_steps(cell, log: logs.Log, seed: int, batches: List[dict],
                    device: torch.device, dtype: torch.dtype = torch.float32,
                    starts: Optional[List[dict]] = None,
                    keep_starts: bool = False, model_class=SelfGNNSeq
                    ) -> dict:
    """`train.reference_steps` on the per-token reference (model_class;
    the pooled `selfgnn.SelfGNN` for a fault): the first step from the
    seed's weights and a fresh optimizer, each later step n from
    `starts[n - 1]` where given. Returns each step's loss, gradient norms
    per leaf ("grads"; "grad", the first's) and change of the parameters
    per leaf, and with keep_starts its own state before each later
    step."""
    m, tr = cell.model, cell.config["train"]
    U, I = log.num_users, log.num_items
    graph = ref.Graph.from_edges(logs.interval_edges(log, m["graph_num"]),
                                 U, I, device)
    model = model_class(m, graph)
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


def check(prog: Program, device: torch.device) -> Dict[str, float]:
    """The numbers that decide `correct` (the program's state is freed
    first)."""
    cell, log, seed, rec = prog.cell, prog.log, prog.seed, prog.record
    prog.release()
    ref.set_tf32(False)
    want = reference_steps(cell, log, seed, rec["batches"], device,
                           starts=rec["starts"])
    numbers = oracle.train_numbers(rec, want)
    numbers["batch_faults"] = train.check_batches(rec["batches"], log, cell)
    return numbers
