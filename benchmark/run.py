"""Run one cell of the benchmark of `sagnn_tpu_torch` once, on the card.

    python3 benchmark/run.py --workload gowalla.train --seed 7 \\
        --seconds 10 --trace 0

Prints, as its last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (with --trace 0 the cell's end-to-end
metrics, with --trace 1 its per-layer metrics), `device`, with --trace 1
`breakdown`, and last `check`, each number that decided `correct` beside
its limit (also the last lines of standard error). Exits non-zero with no
result when no card (or fewer than the cell asks for) is visible, and when
the process has loaded JAX or the JAX package.

The cell, its configuration, traffic, log, limits and per-layer readers are
found by name (`BENCHMARK.json`, `benchmark/configs`, `traffic`, `logs`,
`limits`, `metrics`), and so is the driver of the traffic's kind
(`benchmark/harness/<kind>.py`). The kernels and the native sampler are built into
`sagnn_tpu_torch/build/` inside the checkout on the first run.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import cells, guard, oracle  # noqa: E402
from benchmark.harness.trace import Tracer  # noqa: E402


def driver(kind: str):
    """The module that runs a traffic kind: `benchmark/harness/<kind>.py`,
    with `Program` (set-up; `window`, `release`), `end_to_end`,
    `layer_context` and `check`."""
    return importlib.import_module("benchmark.harness." + kind)


def reader(name: str):
    """The per-layer metric `name`'s reader (`benchmark/metrics/<name>.py`)."""
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_info() -> dict:
    """The card's name and power limit (nvidia-smi), where it answers."""
    import torch
    info = {"kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        info["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return info


def run_cell(cell, bench: dict, seed: int, seconds: float, trace: bool,
             device, t0: float) -> dict:
    """One run of `cell` on `device`: set-up, the window, the check.
    Returns the result object (without the module check)."""
    import torch

    on_card = device.type == "cuda"
    drv = driver(cell.kind)
    prog = drv.Program(cell, seed, device)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print("set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                prog.stages.items())
          + f"; in all {setup_s:.3f} s", file=sys.stderr)
    tracer = Tracer(trace and on_card)
    with tracer:
        meas = prog.window(seconds, on_card, trace=trace)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    print(f"window {meas['window_s']:.3f} s in {len(meas['rounds_s'])} "
          "rounds of " + " ".join(f"{r:.3f}" for r in meas["rounds_s"])
          + " s", file=sys.stderr)
    summary = tracer.summary(meas["window_s"])
    if trace:
        ctx = {"kind": cell.kind, "trace": summary,
               **drv.layer_context(prog, meas)}
        metrics = {}
        for m in cells.per_layer_metrics(bench, cell.name):
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**drv.end_to_end(meas), "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cells.end_to_end_metrics(bench, cell.name)}
    attempted = meas["attempted"]
    t_check = time.perf_counter()
    numbers = drv.check(prog, device)
    print(f"check took {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    verdict = oracle.judge(numbers, cell.limits)
    dev = {"platform": "gpu" if on_card else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if on_card:
        dev.update(card_info())
    out = {"correct": verdict["correct"], "attempted": attempted,
           "failed": 0, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["check"] = {k: {"value": _plain(c["value"]), "limit": c["limit"]}
                    for k, c in verdict["check"].items()}
    return out


def _plain(x: float):
    """A number as JSON can hold it: a non-finite one as its name."""
    return x if math.isfinite(x) else str(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = cells.load_cell(args.workload, bench)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"no result: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, bench, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T0)
    found = guard.banned_modules()
    if found:
        print(f"no result: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
