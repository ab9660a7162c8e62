"""The span reduction (`harness/spans.py`) on made-up kineto events: a
forward kernel charged to its innermost span, a backward kernel charged
through its node's sequence number to the forward op's span, one with no
forward op to the main thread's span, subtree sums, and the span readers,
which read nothing where the trace holds no span."""

from __future__ import annotations

import importlib.util
import os

import pytest

from conftest import ROOT, load_benchmark

MAIN, ENGINE, SAMPLER = 1, 2, 3
BWD = "autograd::engine::evaluate_function: "
SPAN_METRICS = {
    "batch_wait_ms.train", "propagation_ms.train", "fusion_ms.train",
    "losses_ms.train", "optimizer_ms.train", "sequences_ms.serve",
    "score_ms.serve", "topk_ms.serve"}


class _Event:
    """A kineto event, with only the methods that the oldest torch the
    benchmark meets (2.11) has."""

    def __init__(self, name, start, dur, tid=MAIN, corr=0, link=0, seq=-1,
                 fwd_tid=0, cuda=False, annotation=None):
        if annotation is None:          # a record_function span
            annotation = name.startswith("sagnn.") or name == "bench.window"
        self.v = dict(name=name, start=start, dur=dur, tid=tid, corr=corr,
                      link=link, seq=seq, fwd_tid=fwd_tid, cuda=cuda,
                      annotation=annotation)

    def name(self):
        return self.v["name"]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self.v["cuda"] else DeviceType.CPU

    def start_ns(self):
        return self.v["start"]

    def duration_ns(self):
        return self.v["dur"]

    def start_thread_id(self):
        return self.v["tid"]

    def correlation_id(self):
        return self.v["corr"]

    def linked_correlation_id(self):
        return self.v["link"]

    def sequence_nr(self):
        return self.v["seq"]

    def fwd_thread_id(self):
        return self.v["fwd_tid"]

    def is_user_annotation(self):
        return self.v["annotation"]


def _kernel(name, link, dur, start=0):
    return _Event(name, start, dur, tid=0, link=link, cuda=True)


def _step_events():
    """One made-up training step: forward ops under the propagation, the
    fusion and the sequence branch inside the losses; their backward on
    the engine's thread; a batch copy on the sampler's thread."""
    return [
        _Event("bench.window", 0, 1000),
        _Event("sagnn.train.step", 10, 890),
        _Event("sagnn.model.propagation", 20, 180),
        _Event("SpmmFunction", 30, 50, corr=11, seq=7),
        _Event("sagnn.model.fusion", 210, 190),
        _Event("aten::mul", 220, 10, corr=12, seq=8),
        # a launch's runtime event, whose own correlation id (another
        # numbering) is the mul's
        _Event("cudaLaunchKernel", 40, 2, corr=12, link=11),
        _Event("sagnn.model.losses", 410, 90),
        _Event("sagnn.model.sequence", 420, 30),
        _Event("aten::mm", 425, 10, corr=13, seq=9),
        _Event("sagnn.train.backward", 500, 300),
        _Event("aten::zeros_like", 790, 5, corr=14),
        # the engine's thread: SpmmFunction's node, the root (no forward
        # op), mm's node
        _Event(BWD + "SpmmFunctionBackward", 520, 40, tid=ENGINE, corr=21,
               seq=7, fwd_tid=MAIN),
        _Event("SpmmFunctionBackward", 525, 10, tid=ENGINE, corr=22, seq=7),
        _Event(BWD + "torch::autograd::GraphRoot", 510, 5, tid=ENGINE,
               corr=24, seq=-1, fwd_tid=MAIN),
        _Event(BWD + "MmBackward0", 600, 50, tid=ENGINE, corr=25, seq=9,
               fwd_tid=MAIN),
        _Event("aten::mm", 610, 10, tid=ENGINE, corr=23, seq=9),
        _Event("aten::copy_", 100, 10, tid=SAMPLER, corr=31),
        _kernel("k_prop", 11, 100),
        _kernel("k_fusion", 12, 200),
        _kernel("k_seq", 13, 50),
        _kernel("k_prop_bwd", 22, 30),
        _kernel("k_seq_bwd", 23, 40),
        _kernel("k_root", 24, 7),
        _kernel("k_zero", 14, 5),
        _kernel("Memcpy HtoD", 31, 9),
        _kernel("k_unlinked", 0, 3),
        _Event("sagnn.model.fusion", 215, 5, tid=0, cuda=True,
               annotation=True),
    ]


def _reduced():
    from benchmark.harness.spans import reduce_spans
    return reduce_spans(_step_events())


def test_a_forward_kernel_goes_to_its_innermost_span():
    s = _reduced()
    step = "sagnn.train.step"
    assert s.device_s[step + "/sagnn.model.fusion"] == pytest.approx(200e-9)
    assert s.device_s[step + "/sagnn.model.losses/sagnn.model.sequence"] \
        == pytest.approx((50 + 40) * 1e-9)


def test_a_backward_kernel_goes_to_its_forward_span():
    s = _reduced()
    assert s.device_s["sagnn.train.step/sagnn.model.propagation"] == \
        pytest.approx((100 + 30) * 1e-9)


def test_a_backward_kernel_with_no_forward_op_goes_to_the_backward_span():
    s = _reduced()
    assert s.device_s["sagnn.train.step/sagnn.train.backward"] == \
        pytest.approx((7 + 5) * 1e-9)
    # the sampler's copy and the unlinked kernel; the annotation is no
    # device work
    assert s.unspanned == {"Memcpy HtoD": pytest.approx(9e-9),
                           "k_unlinked": pytest.approx(3e-9)}
    assert sum(s.device_s.values()) == pytest.approx(444e-9)


def test_a_subtree_sums_the_spans_inside_it():
    s = _reduced()
    assert s.subtree_s("sagnn.model.losses") == pytest.approx(90e-9)
    assert s.subtree_s("sagnn.model.sequence") == pytest.approx(90e-9)
    assert s.subtree_s("sagnn.train.step") == pytest.approx(432e-9)
    assert s.subtree_s("sagnn.train.optimizer") is None
    assert s.host_s("sagnn.train.step") == pytest.approx(890e-9)
    assert s.host["sagnn.model.propagation"] == (pytest.approx(180e-9), 1)
    assert s.host_s("sagnn.serve.request") is None


def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_the_span_metrics_are_declared():
    b = load_benchmark()
    got = {m["name"]: m for m in b["per_layer"]
           if m["source"] == "program_span" and m["name"] in SPAN_METRICS}
    assert set(got) == SPAN_METRICS
    for name, m in got.items():
        cells = ["gowalla.train", "yelp.train"] if name.endswith(".train") \
            else ["gowalla.serve", "yelp.serve"]
        assert m["workloads"] == cells and m["unit"] == "ms"


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_a_span_reader_reads_nothing_without_spans(name):
    from benchmark.harness.spans import SpanSummary
    kind = "train" if name.endswith(".train") else "refresh"
    read = _reader(name)
    base = {"kind": kind, "trace": object(), "steps": 10, "requests": 10}
    # a trace of a program without spans
    assert read(dict(base, spans=SpanSummary())) is None
    assert read(dict(base, spans=None)) is None
    assert read({"kind": kind, "trace": None}) is None
    assert read({"kind": "none", "trace": None}) is None


def test_the_span_readers_divide_by_steps_and_requests():
    from benchmark.harness.spans import reduce_spans
    events = _step_events() + [
        _Event("sagnn.train.wait_batch", 902, 40),
        _Event("sagnn.train.optimizer", 960, 20),
        _Event("aten::add_", 965, 5, corr=41),
        _kernel("k_adam", 41, 60)]
    ctx = {"kind": "train", "trace": object(), "steps": 2,
           "spans": reduce_spans(events)}
    assert _reader("propagation_ms.train")(ctx) == pytest.approx(65e-6)
    assert _reader("losses_ms.train")(ctx) == pytest.approx(45e-6)
    assert _reader("optimizer_ms.train")(ctx) == pytest.approx(30e-6)
    assert _reader("batch_wait_ms.train")(ctx) == pytest.approx(20e-6)
    assert _reader("score_ms.serve")(ctx) is None


def test_a_reader_finds_the_events_on_the_run_s_tracer():
    """`run.py` passes the readers the summary alone: the events come from
    the Tracer its run holds, reduced once for all readers."""
    import types

    from benchmark.harness.trace import Tracer

    tracer = Tracer(False)
    results = types.SimpleNamespace(events=_step_events)
    tracer.prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))

    def run_cell():                    # as run.py calls the readers
        ctx = {"kind": "train", "trace": object(), "steps": 2}
        got = [_reader(n)(ctx) for n in ("propagation_ms.train",
                                         "fusion_ms.train")]
        return got, ctx, tracer

    got, ctx, _ = run_cell()
    assert got == [pytest.approx(65e-6), pytest.approx(100e-6)]
    assert ctx["spans"].subtree_s("sagnn.train.step") == \
        pytest.approx(432e-9)


def test_a_reader_reads_nothing_with_no_tracer_in_reach():
    ctx = {"kind": "train", "trace": object(), "steps": 2}
    assert _reader("fusion_ms.train")(ctx) is None and ctx["spans"] is None
