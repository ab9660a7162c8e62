"""The port's profiler hooks on the CPU: `span` (no profiler call while
none records, a CPU event of the trace while one does; the spans of a
traced epoch and a traced request nest as `PERF.md` lists them, every
backward node finds its forward op inside a span, and a profiler changes
no number), `trace` (a no-op without a directory, a torch.profiler trace
with one), and `main --profile_dir`, which profiles a throwaway epoch and
leaves the run that follows unchanged bit for bit.
"""

import glob
import json
import os
import re
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sagnn_tpu_torch import main as tmain
from sagnn_tpu_torch.train import trainer as trainer_mod
from sagnn_tpu_torch.utils import profiling
from sagnn_tpu_torch.utils.profiling import span, trace

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

BACKWARD = "autograd::engine::evaluate_function: "
# the spans of one training step and of one request, each with the span
# it sits in directly (PERF.md, section 3)
TRAIN_PARENT = {
    "sagnn.train.wait_batch": "sagnn.train.epoch",
    "sagnn.train.step": "sagnn.train.epoch",
    "sagnn.model.propagation": "sagnn.train.step",
    "sagnn.model.fusion": "sagnn.train.step",
    "sagnn.model.losses": "sagnn.train.step",
    "sagnn.model.sequence": "sagnn.model.losses",
    "sagnn.train.backward": "sagnn.train.step",
    "sagnn.train.optimizer": "sagnn.train.step",
}
SERVE_PARENT = {
    "sagnn.serve.sequences": "sagnn.serve.request",
    "sagnn.serve.score": "sagnn.serve.request",
    "sagnn.model.sequence": "sagnn.serve.score",
}


def _tiny():
    from sagnn_tpu_torch.config import Config, ModelConfig, TrainConfig
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    bundle = synthetic_dataset(num_users=48, num_items=64, graph_num=2,
                               test_size=8, seed=2)
    cfg = Config(model=ModelConfig(latdim=16, graph_num=2, gnn_layer=2,
                                   att_layer=1, num_heads=4, ssldim=8,
                                   pos_length=10, keep_rate=0.5,
                                   spmm_backend="pallas"),
                 train=TrainConfig(batch=16, trn_num=32, samp_num=4,
                                   ssl_num=3, test_size=8, seed=5))
    return cfg, bundle


def _traced(fn):
    """fn() under a CPU profiler; its kineto events and the thread that
    called it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.caller"):
            fn()
    events = prof.profiler.kineto_results.events()
    caller = next(e for e in events if e.name() == "test.caller")
    return events, caller.start_thread_id()


def _spans(events):
    """(start, end, name, thread) of the sagnn spans."""
    return [(e.start_ns(), e.end_ns(), e.name(), e.start_thread_id())
            for e in events if e.name().startswith("sagnn.")]


def _innermost(spans, tid, t, but=None):
    """The name of the innermost span around time t on thread tid."""
    around = [(s, e, n) for s, e, n, th in spans
              if th == tid and s <= t < e and (s, e, n) != but]
    return max(around)[2] if around else None


def test_span_makes_no_profiler_call_while_none_records(monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: calls.append(name))
    with span("sagnn.test.off") as got:
        x = torch.ones(4).sum()
    assert got is None and float(x) == 4.0
    assert calls == []
    assert span("sagnn.a") is span("sagnn.b")


def test_span_is_a_cpu_event_of_the_trace():
    events, tid = _traced(lambda: _span_work("sagnn.test.on"))
    got = [e for e in events if e.name() == "sagnn.test.on"]
    assert len(got) == 1 and got[0].start_thread_id() == tid
    inner = [e for e in events if e.name() == "aten::mm"]
    assert inner and all(got[0].start_ns() <= e.start_ns()
                         and e.end_ns() <= got[0].end_ns() for e in inner)


def _span_work(name):
    with span(name):
        torch.randn(8, 8) @ torch.randn(8, 8)


def _traced_epoch(tmp_path):
    cfg, bundle = _tiny()
    tr = trainer_mod.Trainer(cfg, bundle, ckpt_root=str(tmp_path),
                             device="cpu")
    events, tid = _traced(lambda: tr.train_epoch(verbose=False))
    return events, tid, tr._steps_last_epoch


def test_traced_epoch_spans_nest_on_the_main_thread(tmp_path):
    events, tid, steps = _traced_epoch(tmp_path)
    spans = _spans(events)
    assert {th for *_, th in spans} == {tid}
    names = Counter(n for _, _, n, _ in spans)
    assert names["sagnn.train.epoch"] == 1
    for n in ("sagnn.train.step", "sagnn.train.wait_batch",
              "sagnn.model.propagation", "sagnn.model.fusion",
              "sagnn.model.sequence", "sagnn.train.backward",
              "sagnn.train.optimizer"):
        assert names[n] == steps, n
    # batch_losses and the L2 term each step
    assert names["sagnn.model.losses"] == 2 * steps
    for s, e, n, _ in spans:
        if n in TRAIN_PARENT:
            assert _innermost(spans, tid, s, but=(s, e, n)) == \
                TRAIN_PARENT[n], n


def test_backward_nodes_find_their_forward_ops_in_spans(tmp_path):
    """Every backward node run under sagnn.train.backward that carries a
    sequence number finds the forward op that made it (the same thread
    and number, before the node ran, outside the backward) inside a
    span; SpmmFunction's nodes find theirs under the propagation span."""
    events, tid, steps = _traced_epoch(tmp_path)
    spans = _spans(events)
    nodes = [e for e in events if e.name().startswith(BACKWARD)]
    ranges = [(e.start_ns(), e.end_ns()) for e in nodes]
    fwd = {}
    for e in events:
        if (e.sequence_nr() >= 0 and not e.name().startswith(BACKWARD)
                and not any(s <= e.start_ns() < t for s, t in ranges)):
            fwd.setdefault((e.start_thread_id(), e.sequence_nr()),
                           []).append(e.start_ns())
    found = Counter()
    for e in nodes:
        if (_innermost(spans, e.start_thread_id(), e.start_ns())
                != "sagnn.train.backward" or e.sequence_nr() < 0):
            continue
        starts = [t for t in fwd.get((e.fwd_thread_id(), e.sequence_nr()),
                                     []) if t < e.start_ns()]
        assert starts, e.name()
        where = _innermost(spans, e.fwd_thread_id(), max(starts))
        assert where is not None and where.startswith("sagnn."), e.name()
        found[(e.name()[len(BACKWARD):], where)] += 1
    assert found[("SpmmFunctionBackward", "sagnn.model.propagation")] > 0
    assert sum(found.values()) > 100


@pytest.mark.parametrize("chunk_rows", [-1, 16])
def test_traced_request_spans_nest(chunk_rows):
    """Recommender.recommend's spans, dense and chunked: the request
    around the sequences, the score (the sequence branch inside) and,
    dense, the top-k beside it."""
    from sagnn_tpu_torch.serve import Recommender
    cfg, bundle = _tiny()
    rec = Recommender(cfg, bundle, device="cpu")
    rec.encode()
    events, tid = _traced(lambda: rec.recommend([0, 3, 5], k=4,
                                                chunk_rows=chunk_rows))
    spans = _spans(events)
    assert {th for *_, th in spans} == {tid}
    names = Counter(n for _, _, n, _ in spans)
    want = {"sagnn.serve.request": 1, "sagnn.serve.sequences": 1,
            "sagnn.serve.score": 1, "sagnn.model.sequence": 1}
    if chunk_rows < 0:
        want["sagnn.serve.topk"] = 1
    assert dict(names) == want
    parent = dict(SERVE_PARENT, **{"sagnn.serve.topk":
                                   "sagnn.serve.request"})
    for s, e, n, _ in spans:
        if n in parent:
            assert _innermost(spans, tid, s, but=(s, e, n)) == parent[n], n


def test_a_profiler_changes_no_number(tmp_path):
    """One epoch with a profiler open and one without, from the same
    seed: the same losses and parameters, bit for bit."""
    cfg, bundle = _tiny()
    runs = []
    for traced in (False, True):
        tr = trainer_mod.Trainer(cfg, bundle, device="cpu",
                                 ckpt_root=str(tmp_path / str(traced)))
        if traced:
            _traced(lambda: tr.train_epoch(verbose=False))
        else:
            tr.train_epoch(verbose=False)
        runs.append(tr)
    a, b = runs
    assert a.step_stats == b.step_stats and len(a.step_stats) == 2
    for k, v in a.state["params"].items():
        assert torch.equal(v.detach(), b.state["params"][k].detach()), k


def test_trace_none_is_a_no_op(tmp_path):
    with trace(None):
        x = torch.ones(8).sum()
    assert float(x) == 8.0
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_cpu_trace(tmp_path):
    with trace(str(tmp_path / "tr"), cuda=False):
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    ops = [e["name"] for e in events if e.get("cat") == "cpu_op"]
    assert any("mm" in name for name in ops)


def test_trace_file_holds_the_spans(tmp_path):
    """The operator's trace (`trace`, what --profile_dir writes) holds a
    traced epoch's spans as user annotations, one step span a step."""
    cfg, bundle = _tiny()
    tr = trainer_mod.Trainer(cfg, bundle, ckpt_root=str(tmp_path),
                             device="cpu")
    with trace(str(tmp_path / "tr"), cuda=False):
        tr.train_epoch(verbose=False)
    files = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json"))
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = Counter(e["name"] for e in events
                    if e.get("cat") == "user_annotation")
    assert names["sagnn.train.step"] == tr._steps_last_epoch == 2
    assert names["sagnn.train.epoch"] == 1


def _run_cli(argv, monkeypatch, capsys):
    """main(argv) in this process; the Trainer it built and its stdout
    lines without their timestamps."""
    made = []

    class Recording(trainer_mod.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(trainer_mod, "Trainer", Recording)
    tmain.main(argv)
    out = capsys.readouterr().out
    lines = [re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d: ", "", x)
             for x in out.replace("\r", "\n").splitlines()]
    return made[0], [x for x in lines if "loss" in x.lower()]


def test_profile_dir_leaves_the_run_unchanged(tmp_path, monkeypatch, capsys):
    """The same CLI run with and without --profile_dir (keepRate 0.5, so
    the dropout generator is restored too): final params, Adam moments,
    counts and every logged loss bit for bit equal; the trace is written."""
    base = ["--data", "synthetic", "--device", "cpu", "--synth_users", "48",
            "--synth_items", "64", "--graphNum", "2", "--epoch", "2",
            "--trnNum", "32", "--batch", "16", "--testSize", "8",
            "--sslNum", "3", "--sampNum", "4", "--latdim", "16",
            "--num_attention_heads", "4", "--ssldim", "8", "--pos_length",
            "10", "--att_layer", "1", "--tstEpoch", "1", "--keepRate", "0.5",
            "--spmm_backend", "pallas"]
    plain, plain_log = _run_cli(
        base + ["--ckpt_root", str(tmp_path / "a")], monkeypatch, capsys)
    prof, prof_log = _run_cli(
        base + ["--ckpt_root", str(tmp_path / "b"), "--profile_dir",
                str(tmp_path / "prof")], monkeypatch, capsys)
    assert plain_log and plain_log == prof_log
    assert plain.history.data == prof.history.data
    a, b = plain.state, prof.state
    assert a["step"] == b["step"] == 4
    assert a["opt_state"].count == b["opt_state"].count
    for k in a["params"]:
        for x, y in ((a["params"][k], b["params"][k]),
                     (a["opt_state"].mu[k], b["opt_state"].mu[k]),
                     (a["opt_state"].nu[k], b["opt_state"].nu[k])):
            assert torch.equal(x.detach(), y.detach()), k
    assert torch.equal(plain.dropout_gen.get_state(),
                       prof.dropout_gen.get_state())
    assert (plain.sampler.rng.bit_generator.state
            == prof.sampler.rng.bit_generator.state)
    files = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(files) == 1
    assert np.isfinite(plain.history.data["TrainLoss"]).all()


def test_profile_epoch_restores_state_and_rng(tmp_path):
    """profile_epoch alone: the Trainer's state and both RNGs after it are
    the ones before it."""
    cfg, bundle = _tiny()
    tr = trainer_mod.Trainer(cfg, bundle, ckpt_root=str(tmp_path),
                             device="cpu")
    before = {k: v.detach().clone() for k, v in tr.state["params"].items()}
    rng = tr.capture_rng_state(0)
    tmain.profile_epoch(tr, str(tmp_path / "p"))
    assert tr.state["step"] == 0 and tr.state["opt_state"].count == 0
    for k, v in tr.state["params"].items():
        assert torch.equal(v.detach(), before[k]) and v.requires_grad
    assert all(float(m.abs().max()) == 0.0
               for m in tr.state["opt_state"].mu.values())
    assert tr.capture_rng_state(0) == rng
