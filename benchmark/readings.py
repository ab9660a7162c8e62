"""The readings that the limits of `correct` are set from, at a cell's own
size: for each seed, the program's numbers against the reference (the
lower reading), and optionally the control's (the reference itself,
standing in the program's place, computed with TF32 on: the precision
below the configuration's f32 with TF32 off) and the program's own bf16
mode's (`spmm_exact=False`, `fusion_dtype="bf16"`), and for a train cell
optionally a fault's (the reference with half of each batch left out, the
mean over the rest, in the program's place). What stands in the program's
place is judged as the program is: the f32 reference steps from its state
before each checked step. No window is timed: a train cell's readings come
from set-up's checked steps, a refresh cell's from one pass of requests.

    python3 benchmark/readings.py --workload gowalla.train \\
        --seeds 11 12 13 --control --faults [--out chiprun_out/r.jsonl]

One JSON line per seed on standard output (and appended to --out).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import cells, oracle  # noqa: E402
from benchmark.reference import selfgnn as ref  # noqa: E402

BF16 = {"spmm_exact": False, "fusion_dtype": "bf16"}


def train_readings(cell, seed: int, device, control: bool, bf16: bool,
                   faults: bool = False, witness: bool = False) -> dict:
    """The numbers of each variant against the f32 reference stepping from
    that variant's states, and each variant's raw record (losses, per-leaf
    norms; the reference's beside it under "reference_<variant>").
    witness: the program judged by the reference again in f32 (its
    atomics add in another order) and in f64, each from the program's
    states."""
    import numpy as np
    import torch

    from benchmark.harness import train

    out, raw = {}, {}
    t0 = time.perf_counter()
    prog = train.Program(cell, seed, device)
    out["setup_s"] = time.perf_counter() - t0
    log, rec = prog.log, prog.record
    batches = rec["batches"]
    out["batch_faults"] = train.check_batches(batches, log, cell)
    prog.release()

    def steps(bs=batches, dtype=torch.float32, tf32=False, starts=None,
              keep_starts=False):
        ref.set_tf32(tf32)
        try:
            return train.reference_steps(cell, log, seed, bs, device, dtype,
                                         starts, keep_starts)
        finally:
            ref.set_tf32(False)

    def judged(name, got, dtype=torch.float32):
        want = steps(dtype=dtype, starts=got.get("starts"))
        out[name] = oracle.train_numbers(got, want)
        raw[name] = {k: got[k] for k in ("losses", "grad", "change")}
        raw["reference_" + name] = {k: want[k] for k in
                                    ("losses", "grads", "change")}

    judged("program", rec)
    if witness:
        for name, dtype in (("program_vs_f32_again", torch.float32),
                            ("program_vs_f64", torch.float64)):
            try:
                judged(name, rec, dtype)
            except torch.cuda.OutOfMemoryError:
                out[name] = "out of memory"
                torch.cuda.empty_cache()
    if control:
        judged("control_tf32", steps(tf32=True, keep_starts=True))
    if faults:
        half = []
        for b in batches:
            b = dict(b)
            b["pair_mask"] = b["pair_mask"].copy()
            b["pair_mask"][len(b["pair_mask"]) // 2:] = 0
            half.append(b)
        judged("fault_half_batch", steps(half, keep_starts=True))
    if bf16:
        low = train.Program(cell, seed, device, **BF16)
        low_rec = low.record
        low.release()
        if not all(np.array_equal(a[f], b[f]) for a, b in
                   zip(low_rec["batches"], batches) for f in a):
            out["program_bf16_batches_differ"] = True
        judged("program_bf16", low_rec)
    out["raw"] = raw
    return out


def serve_readings(cell, seed: int, device, control: bool, bf16: bool,
                   faults: bool = False, witness: bool = False) -> dict:
    import torch

    from benchmark.harness import refresh

    def one_pass(prog):
        prog.window(0.0, device.type == "cuda")
        picked = [prog.results[i]
                  for i in refresh.sample(len(prog.results), seed)]
        prog.release()
        return picked

    out = {}
    t0 = time.perf_counter()
    prog = refresh.Program(cell, seed, device)
    out["setup_s"] = time.perf_counter() - t0
    log, requests = prog.log, prog.requests
    picked = one_pass(prog)
    ref.set_tf32(False)
    server = refresh.ReferenceServer(cell, log, seed, device)
    out["program"] = refresh.judge_results(server, requests, picked)
    if control:
        ref.set_tf32(True)
        tf32 = refresh.ReferenceServer(cell, log, seed, device)
        worst = {}
        for r, _, _ in picked:
            scores, ids = tf32.top_k(requests[r], int(cell.traffic["k"]))
            ref.set_tf32(False)
            got = oracle.serve_numbers(
                torch.from_numpy(scores).to(device),
                torch.from_numpy(ids).to(device), server.scores(requests[r]))
            ref.set_tf32(True)
            for k, v in got.items():
                worst[k] = max(worst.get(k, 0.0), v)
        ref.set_tf32(False)
        del tf32
        out["control_tf32"] = worst
    if bf16:
        low = refresh.Program(cell, seed, device, **BF16)
        out["program_bf16"] = refresh.judge_results(server, requests,
                                                  one_pass(low))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--faults", action="store_true",
                    help="train cells: the reference with half of each "
                    "batch left out (the mean over the rest) in the "
                    "program's place")
    ap.add_argument("--witness", action="store_true",
                    help="train cells: the program judged by the "
                    "reference again in f32 and in f64")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no card visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = cells.load_cell(args.workload)
    fn = train_readings if cell.kind == "train" else serve_readings
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = {"workload": cell.name, "seed": seed,
                **fn(cell, seed, device, args.control, args.bf16,
                     args.faults, args.witness)}
        line["seconds"] = time.perf_counter() - t0
        line["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
