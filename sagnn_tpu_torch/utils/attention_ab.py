"""Time the edge-attention encode and training step of two or more
checkouts of this repo on one card, alternately, so that a kernel change
can be told from the spread of host-bound calls.

    python sagnn_tpu_torch/utils/attention_ab.py PARENT CHANGE --rounds 2

runs, for each round, one process per checkout in the order PARENT,
CHANGE, CHANGE, PARENT (the second half of the round reversed), each
importing `sagnn_tpu_torch` from its own checkout. Every process builds
that checkout's kernels, takes the gowalla-width set-up of `chip_smoke.py`
(the gowalla preset with edge attention on the kernel path, 49,152 users
x 40,960 items, data seed 7, weights from seed 0, keepRate 1, the first
batch of the sampler) and times, on f32 and on bf16 tables:

  * the attention encode (`Recommender.encode`) and the training step
    (the whole loss and every gradient), each the mean of `--reps` calls
    as called (CUDA events, the host's cost included);
  * one profiled step (torch.profiler over 3 steps): its wall and device
    time per step and the device time of the K5 (SDDMM) kernels in it.

Each process prints one JSON line; the last line is a summary with every
line grouped by checkout. The set-up's bundle is built once, by the first
process, and kept in `<this checkout>/sagnn_tpu_torch/build/` (git-ignored)
for the others. Needs a card; imports nothing of the checkouts but their
`sagnn_tpu_torch`, which must take the calls above.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time

NUM_USERS, NUM_ITEMS = 49_152, 40_960
SEQ_LEN_RANGE, DATA_SEED, PARAM_SEED = (10, 50), 7, 0
PROFILE_STEPS = 3
HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(os.path.dirname(HERE), "build", "attention_ab_bundle.pkl")


def _profiled(fn, n):
    """(wall ms, device ms, K5 device ms) per call of fn over n calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    times = {e.key: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / n
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA}
    if not times:
        return wall, None, None
    return wall, sum(times.values()), sum(
        v for k, v in times.items() if "sddmm" in k.lower())


def worker(checkout: str, cache: str, reps: int,
           device: str = "cuda") -> dict:
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    from sagnn_tpu_torch.config import PRESETS
    from sagnn_tpu_torch.data.sampler import Sampler
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.models import selfgnn
    from sagnn_tpu_torch.ops import _build
    from sagnn_tpu_torch.serve import Recommender
    from sagnn_tpu_torch.utils.profiling import cuda_ms

    import sagnn_tpu_torch
    assert os.path.dirname(os.path.dirname(sagnn_tpu_torch.__file__)) == \
        os.path.abspath(checkout), sagnn_tpu_torch.__file__
    device = torch.device(device)
    if device.type == "cuda":
        _build.build()
        _build.load_library()
    t0 = time.perf_counter()
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            bundle = pickle.load(f)
    else:
        bundle = synthetic_dataset(num_users=NUM_USERS, num_items=NUM_ITEMS,
                                   graph_num=PRESETS["gowalla"].model
                                   .graph_num,
                                   test_size=PRESETS["gowalla"].train
                                   .test_size,
                                   seed=DATA_SEED,
                                   seq_len_range=SEQ_LEN_RANGE)
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        with open(cache, "wb") as f:
            pickle.dump(bundle, f, protocol=pickle.HIGHEST_PROTOCOL)
    bundle_s = time.perf_counter() - t0
    base = PRESETS["gowalla"]
    cfg = base.replace(
        model=dataclasses.replace(base.model, spmm_backend="pallas",
                                  edge_attention=True),
        train=dataclasses.replace(base.train, seed=PARAM_SEED))
    tc = cfg.train
    out = {"checkout": checkout, "bundle_s": bundle_s, "reps": reps}
    params = None
    batch = None
    for exact in (True, False):
        mc = dataclasses.replace(cfg.model, spmm_exact=exact)
        rec = Recommender(cfg.replace(model=mc), bundle, params,
                          device=device)
        params = rec.params
        if batch is None:
            sampler = Sampler(bundle, batch=tc.batch, samp_num=tc.samp_num,
                              ssl_num=tc.ssl_num, pred_num=tc.pred_num,
                              pos_length=mc.pos_length,
                              test_size=tc.test_size, seed=tc.seed)
            ids = sampler.epoch_user_ids(tc.trn_num)
            batch = sampler.train_batch(ids[:tc.batch]).to(device)
        model = selfgnn.SelfGNN(dataclasses.replace(mc, keep_rate=1.0),
                                bundle.num_users, bundle.num_items)
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        keys = sorted(leaves)

        def step():
            pre, ssl, _ = model.train_losses(leaves, rec.graphs, batch, None)
            loss = pre + tc.reg * selfgnn.reg_loss(leaves) \
                + tc.ssl_reg * ssl
            return torch.autograd.grad(loss, [leaves[k] for k in keys],
                                       allow_unused=True)

        mode = "f32" if exact else "bf16"
        out[f"encode_ms_{mode}"] = cuda_ms(rec.encode, reps, 2)
        out[f"step_ms_{mode}"] = cuda_ms(step, reps, 2)
        wall, dev, k5 = _profiled(step, PROFILE_STEPS)
        out[f"profiled_step_{mode}"] = {"wall_ms": wall, "device_ms": dev,
                                        "sddmm_device_ms": k5}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--cache", default=CACHE)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.cache, args.reps)),
              flush=True)
        return 0
    if len(args.checkouts) < 2:
        ap.error("give two or more checkouts")
    order = []
    for _ in range(args.rounds):
        order += list(args.checkouts) + list(reversed(args.checkouts))
    lines = []
    for checkout in order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", checkout,
             "--cache", args.cache, "--reps", str(args.reps)],
            capture_output=True, text=True, check=False)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode:
            print(f"{checkout}: exit {res.returncode}", file=sys.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(json.loads(line))
    print(json.dumps({c: [r for r in lines if r["checkout"] == c]
                      for c in args.checkouts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
