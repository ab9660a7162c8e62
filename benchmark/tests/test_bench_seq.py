"""The "train_seq" traffic and the cells of the gowalla dataset's size on
the CPU, as `test_bench_reference.py` and `test_bench_faults.py` hold the
others: a tiny whole run of `movielens_seq.train` (its window cut from
200 to 24 positions, past the small-T path's 16, so that the CPU holds
its [512, 16, L, L] scores) and of `gowalla.train_ds` comes out correct;
the per-token faults (the sequence pooled to one token as the released
code has it, the key mask dropped) come out not correct; the per-token
reference imports nothing of the program; the new readers give None
outside their cell."""

from __future__ import annotations

import ast
import os

import pytest
import torch

from conftest import ROOT, load_benchmark, tiny_cell

SEQ_METRICS = ("seq_attention_ms.train", "seq_attention_roofline.train")


def seq_cell(**model):
    cell = tiny_cell("movielens_seq.train")
    cell.config = {**cell.config, "model": {**cell.config["model"],
                                            "pos_length": 24, **model}}
    return cell


def run(cell, seed: int = 3) -> dict:
    from benchmark import run
    return run.run_cell(cell, load_benchmark(), seed, 0.1, False,
                        torch.device("cpu"), 0.0)


def test_sound_run_is_correct(cpu_threads):
    out = run(seq_cell())
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"train_users_per_s", "setup_s"}


def test_dataset_size_cell_is_correct(cpu_threads):
    out = run(tiny_cell("gowalla.train_ds"))
    assert out["correct"], out["check"]


def test_pooled_in_place_of_per_token(cpu_threads):
    """The program runs the released code's pooled branch (quirk Q3); the
    reference attends per token."""
    out = run(seq_cell(per_token_seq_attention=False))
    assert not out["correct"], out["check"]
    assert out["check"]["loss_gap"]["value"] > \
        out["check"]["loss_gap"]["limit"]


def test_key_mask_dropped(monkeypatch, cpu_threads):
    """The program's per-token attention attends the padded slots."""
    from sagnn_tpu_torch.models import selfgnn

    attend = selfgnn.multi_head_self_attention

    def unmasked(params, x, num_heads, stable=False, mask=None):
        return attend(params, x, num_heads, stable,
                      None if mask is None else torch.ones_like(mask))

    monkeypatch.setattr(selfgnn, "multi_head_self_attention", unmasked)
    out = run(seq_cell())
    assert not out["correct"], out["check"]


def test_per_token_reference_imports_only_torch_and_its_base():
    with open(os.path.join(ROOT, "benchmark", "reference",
                           "selfgnn_seq.py")) as f:
        tree = ast.parse(f.read())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            found.add("." * node.level + (node.module or ""))
    assert found == {"__future__", "math", "torch", ".selfgnn"}


@pytest.mark.parametrize("name", SEQ_METRICS)
def test_seq_readers_give_none_outside_their_cell(name):
    from benchmark.harness.trace import TraceSummary
    from benchmark.run import reader

    read = reader(name)
    trace = TraceSummary(busy_s=1.0, window_s=2.0)
    # a serve cell, an untraced run, a train cell of a program without
    # the counter, and a traced train cell whose trace holds no such span
    assert read({"kind": "refresh", "trace": trace, "requests": 3}) is None
    assert read({"kind": "train", "trace": None, "steps": 3,
                 "seq_rows": 30, "seq_bound_s_per_row": 1e-9}) is None
    assert read({"kind": "train", "trace": trace, "steps": 3,
                 "seq_rows": None, "seq_bound_s_per_row": 1e-9,
                 "spans": _Spans({})}) is None
    assert read({"kind": "train", "trace": trace, "steps": 3,
                 "seq_rows": 30, "seq_bound_s_per_row": 1e-9,
                 "spans": _Spans({"sagnn.train.step/sagnn.model.losses":
                                  0.5})}) is None


def test_seq_readers_in_their_cell():
    """3 steps with 0.3 ms charged inside `sagnn.model.seq_attention`,
    1,536 rows of 1e-8 s bound each."""
    from benchmark.run import reader

    from benchmark.harness.trace import TraceSummary

    spans = _Spans({
        "sagnn.train.step/sagnn.model.losses/sagnn.model.sequence/"
        "sagnn.model.seq_attention": 0.2e-3,
        "sagnn.train.step/sagnn.model.losses/sagnn.model.sequence/"
        "sagnn.model.seq_attention/x": 0.1e-3,
        "sagnn.train.step/sagnn.model.losses": 5e-3})
    ctx = {"kind": "train", "trace": TraceSummary(1.0, 2.0), "steps": 3,
           "seq_rows": 1536, "seq_bound_s_per_row": 1e-8, "spans": spans}
    assert reader("seq_attention_ms.train")(ctx) == pytest.approx(0.1)
    assert reader("seq_attention_roofline.train")(ctx) == \
        pytest.approx(100 * 1536e-8 / 0.3e-3)


def _Spans(device_s):
    from benchmark.harness.spans import SpanSummary
    return SpanSummary(device_s=device_s)
