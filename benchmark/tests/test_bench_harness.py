"""The harness on the CPU: cells and their files found by name, the
operation and byte counts against hand counts, the trace reduction, the
module check, and a run that refuses to report without a card."""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from conftest import ROOT, load_benchmark, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    b = load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert b["command"] == ["python3", "benchmark/run.py"]
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e
    all_names = names + [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in metrics]
    assert len(all_names) == len(set(all_names))
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in
                                  load_benchmark()["workloads"]])
def test_cell_files_found_by_name(name):
    from benchmark.harness import cells

    b = load_benchmark()
    cell = cells.load_cell(name, b)
    assert cell.kind in ("train", "refresh")
    run = _run_module()
    drv = run.driver(cell.kind)        # benchmark/harness/<kind>.py
    for part in ("Program", "end_to_end", "layer_context", "check"):
        assert callable(getattr(drv, part)), part
    assert cell.log["num_users"] > 0 and cell.model["latdim"] == 64
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
    reported = {m["name"] for m in cells.end_to_end_metrics(b, name)}
    assert "setup_s" in reported and len(reported) >= 2
    layer = cells.per_layer_metrics(b, name)
    assert layer
    for m in layer:
        read = run.reader(m["name"])
        assert read({"kind": "none", "trace": None}) is None


def _run_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_run", os.path.join(ROOT, "benchmark", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["gowalla", "yelp"])
def test_config_is_the_preset(name):
    """The file runs the preset as it stands, on the kernel backend:
    `reduced` is empty, so no key may differ from the preset's."""
    from sagnn_tpu_torch.config import PRESETS

    with open(os.path.join(ROOT, "benchmark", "configs",
                           name + ".json")) as f:
        conf = json.load(f)
    preset = PRESETS[name]
    model = dataclasses.asdict(preset.model)
    for k, v in conf["model"].items():
        assert v == ("pallas" if k == "spmm_backend" else model[k]), k
    train = dataclasses.asdict(preset.train)
    for k, v in conf["train"].items():
        assert v == train[k], k


def test_log_generator_repeats_and_splits():
    from benchmark.harness import logs

    params = {**tiny_cell("gowalla.train").log}
    a, b = logs.generate(params, 5), logs.generate(params, 5)
    assert np.array_equal(a.items, b.items) and np.array_equal(a.times,
                                                                 b.times)
    assert not np.array_equal(a.items, logs.generate(params, 6).items)
    U = params["num_users"]
    assert len(a.users) == params["interactions"] + 4 * U
    assert (np.diff(a.bounds) >= 4).all()
    bundle = logs.bundle(a, 3)
    assert sum(m.nnz for m in bundle.sub_mats) == \
        sum(e.shape[1] for e in logs.interval_edges(a, 3))
    assert all(len(s) == a.bounds[u + 1] - a.bounds[u] - 1
               for u, s in enumerate(bundle.sequences))
    assert logs.generate(params, 2 ** 31 + 12345).num_users == U


def test_segsum_bound_by_hand():
    from benchmark.harness import counts

    # 10 targets, 7 distinct sources, 30 edges, d 4: 7*4*4 + 30*4 + 11*4
    # + 10*4*4 bytes = 436; adds 120
    want = max(436 / counts.HBM_BYTES_PER_S, 120 / counts.F32_FLOPS)
    assert counts.segsum_bound_s(10, 7, 30, 4) == pytest.approx(want)
    e = np.array([[0, 0, 1, 2], [3, 4, 3, 3]])
    per = counts.segsum_bound_s(5, 3, 4, 4) + counts.segsum_bound_s(6, 2, 4, 4)
    assert counts.k1_bound_s_per_step([e], 5, 6, 4, 2) == \
        pytest.approx(2 * 2 * per)


def test_train_step_flops_by_hand():
    from benchmark.harness import counts

    m = {"graph_num": 1, "latdim": 2, "pos_length": 3, "ssldim": 1,
         "gnn_layer": 1, "att_layer": 1}
    t = {"batch": 1, "samp_num": 1, "ssl_num": 1}
    # N = 2 + 1 nodes, 5 edges, D 2, T 1
    prop = 2 * 1 * 5 * 2                              # 20 adds
    lstm = 2 * 4 * 8 * 1 * 3                          # 192
    fusion = (6 * 4 * 1 + 4 * 1 * 1 * 2) * 3          # 96
    seq = 2 * 1 * 3 * 2 * 2 + 1 * 1 * (6 * 4 + 4 * 2)  # 24 + 32
    head = 4 * 1 * 2                                  # 8
    ssl = 1 * 1 * (2 * (2 * 6 * 1 + 2) + 8 * 2)       # 44
    reg = 2 * (3 * 2 + 3 * 2 + 2 * 2 + 2 * 1 * 1 * 4 + 6 * 1 + 1)
    want = 2 * prop + 3 * (lstm + fusion + seq + head + ssl) + 1.5 * reg
    assert counts.train_step_flops(m, t, 2, 1, [5]) == pytest.approx(want)


class _Event:
    def __init__(self, name, dev, start, dur, tid=1):
        self._v = (name, dev, start, dur, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]


def test_trace_reduction():
    from torch.autograd import DeviceType

    from benchmark.harness.trace import WINDOW_SPAN, reduce_events

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _Event(WINDOW_SPAN, cpu, 0, 1000),
        _Event("aten::mm", cpu, 100, 300),           # host 100-400
        _Event("aten::copy_", cpu, 150, 50),         # inside mm
        _Event("other thread", cpu, 0, 1000, tid=2),
        _Event("k_a", cuda, 200, 100),               # 200-300
        _Event("k_b", cuda, 250, 150),               # 250-400
        _Event("k_a", cuda, 600, 100),               # 600-700
    ]
    s = reduce_events(events, window_s=1e-6)
    assert s.busy_s == pytest.approx(300e-9)
    assert s.by_name["k_a"] == (pytest.approx(200e-9), 2)
    assert s.kernel_s == pytest.approx(350e-9)
    # gaps 0-200 (mid 100: mm), 400-600 and 700-1000 (no op)
    assert s.idle_by_label["aten::mm"] == pytest.approx(200e-9)
    assert s.idle_by_label["host: no profiled op"] == pytest.approx(500e-9)
    b = s.breakdown()
    assert b["device_ops"][0][0] == "k_a" and len(b["idle_gaps"]) == 2


def test_module_check_compares_whole_names(monkeypatch):
    from benchmark.harness import guard

    monkeypatch.setitem(sys.modules, "sagnn_tpu_torch_fake",
                        types.ModuleType("sagnn_tpu_torch_fake"))
    assert "sagnn_tpu" not in guard.banned_modules()
    monkeypatch.setitem(sys.modules, "sagnn_tpu.models",
                        types.ModuleType("sagnn_tpu.models"))
    assert "sagnn_tpu" in guard.banned_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package(cpu_threads):
    """A whole (tiny, CPU) run in a fresh process, then the check."""
    code = (
        "import sys, torch; sys.path.insert(0, %r); "
        "sys.path.insert(0, %r); torch.set_num_threads(2); "
        "from conftest import tiny_cell, load_benchmark; "
        "from benchmark import run; "
        "from benchmark.harness import guard; "
        "out = run.run_cell(tiny_cell('gowalla.serve'), load_benchmark(), 3,"
        " 0.1, False, torch.device('cpu'), 0.0); "
        "print(guard.banned_modules(), out['correct'])"
    ) % (ROOT, os.path.join(ROOT, "benchmark", "tests"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[] True"


def test_no_result_without_a_card(tmp_path):
    """Where torch sees no card the run exits non-zero and prints no
    result; so does a checkout holding only BENCHMARK.json and the
    benchmark's folder."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    cmd = [sys.executable, "benchmark/run.py", "--workload",
           "gowalla.train", "--seed", "1", "--seconds", "1", "--trace", "0"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
