"""The readings that the limits of a "train_seq" cell's `correct` are set
from (`readings.py` reads the "train" and "refresh" kinds): for each seed
the program's numbers against the per-token reference (the lower
reading) and, optionally, what stands in the program's place (the upper
readings): the reference with TF32 on (the control), and the faults, the
reference with half of each batch left out, with the sequence pooled to
one token (the released code's branch) and with every key of the window
attended, padding included. Each is judged as the program is, the f32
reference stepping from its state before each checked step. No window is
timed: the readings come from set-up's checked steps.

    python3 benchmark/readings_seq.py --workload movielens_seq.train \\
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
from benchmark.reference.selfgnn_seq import SelfGNNSeq, \
    masked_attention  # noqa: E402


class KeysUnmasked(SelfGNNSeq):
    """The per-token reference with the key mask dropped: padded slots
    are attended as if they held items."""

    def attend(self, p, x, mask):
        import torch
        return masked_attention(p, x, torch.ones_like(mask),
                                self.m["num_heads"])


def readings(cell, seed: int, device, control: bool,
             faults: bool) -> dict:
    import torch

    from benchmark.harness import train, train_seq

    out, raw = {}, {}
    t0 = time.perf_counter()
    prog = train_seq.Program(cell, seed, device)
    out["setup_s"] = time.perf_counter() - t0
    log, rec = prog.log, prog.record
    batches = rec["batches"]
    out["batch_faults"] = train.check_batches(batches, log, cell)
    prog.release()

    def steps(bs=batches, tf32=False, starts=None, keep_starts=False,
              model_class=SelfGNNSeq):
        ref.set_tf32(tf32)
        try:
            return train_seq.reference_steps(
                cell, log, seed, bs, device, torch.float32, starts,
                keep_starts, model_class)
        finally:
            ref.set_tf32(False)

    def judged(name, got):
        want = steps(starts=got.get("starts"))
        out[name] = oracle.train_numbers(got, want)
        raw[name] = {k: got[k] for k in ("losses", "grad", "change")}
        raw["reference_" + name] = {k: want[k] for k in
                                    ("losses", "grads", "change")}

    judged("program", rec)
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
        judged("fault_pooled", steps(keep_starts=True,
                                     model_class=ref.SelfGNN))
        judged("fault_keys_unmasked", steps(keep_starts=True,
                                            model_class=KeysUnmasked))
    out["raw"] = raw
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no card visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = cells.load_cell(args.workload)
    if cell.kind != "train_seq":
        print(f"{cell.name} is of kind {cell.kind}: readings.py reads it",
              file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = {"workload": cell.name, "seed": seed,
                **readings(cell, seed, device, args.control, args.faults)}
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
