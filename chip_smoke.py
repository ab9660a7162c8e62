#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; it prints no
result line then):
  1. device  — require CUDA; print the card's name and power limit.
  2. build   — compile sagnn_tpu_torch/csrc/*.cu with nvcc (timed).
  3. set-up  — the synthetic gowalla-scale bundle (49,152 users x 40,960
               items, 3 intervals, sequences of 10-50 items), its graphs
               and CSR plans, and seeded random weights (timed).
  4. kernels — the segment-sum kernel (f32 and bf16 tables) on interval 0
               in both directions, an empty graph and a graph with empty
               rows, each held against its plain PyTorch version; kernel,
               plain and library (torch.sparse.mm) times with CUDA events.
  5. main path — the gowalla preset at full width (latdim 64, 16 heads,
               g=3, gnn_layer 2, att_layer 1, pos_length 200, 1000
               candidates) through `Recommender`: encode through the
               kernel (launch counts read just after), held against the
               plain backend (its propagation summed in f64), top-10 for
               256 users, HR/NDCG over up to 4,096 test users; then the
               bf16-table encode as a second path, held hop by hop
               against the plain version on the inputs it gave each hop.
Prints a `kernels` JSON line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# gowalla-scale synthetic workload (bench.py's node counts and sequence
# lengths; the preset's widths)
NUM_USERS = 49_152
NUM_ITEMS = 40_960
SEQ_LEN_RANGE = (10, 50)
DATA_SEED = 7
PARAM_SEED = 0
SERVE_USERS = 256
EVAL_USERS = 4096
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
KERNEL_SOURCE = "sagnn_tpu_torch/csrc/segsum.cu"
KERNEL_REPLACES = "sagnn_tpu/ops/spmm_pallas.py:218"   # _segsum_kernel


def log(*a):
    print(*a, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def seg_tol(ptr) -> tuple[float, float]:
    """(rtol, atol) for a segment-sum in f32: the stated tolerance,
    rtol 1e-5 and atol 1e-5 * sqrt(max degree)."""
    deg = int((ptr[1:] - ptr[:-1]).max()) if ptr.numel() > 1 else 0
    return 1e-5, 1e-5 * math.sqrt(max(1, deg))


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_close(got, want, rtol, atol, what) -> float:
    """Fails unless |got - want| <= atol + rtol * |want| everywhere and got
    is finite; logs the largest share of the tolerance used. Returns the
    max abs error."""
    import torch
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    used = float((diff / (atol + rtol * want.abs())).max()) \
        if diff.numel() else 0.0
    check(used <= 1.0 and bool(torch.isfinite(got).all()),
          f"{what}: max abs err {err:.3e} (rtol {rtol}, atol {atol:.2e})")
    log(f"  {what}: max abs err {err:.3e}, {used:.2f} of the tolerance")
    return err


def kernel_phase(graphs, device) -> dict:
    """Kernel vs plain (and library) on interval 0, both directions, plus an
    empty graph and a graph with empty rows. Returns per-kernel records."""
    import torch
    from sagnn_tpu_torch.ops import spmm_cuda as sc

    gen = torch.Generator(device=device).manual_seed(1)
    D = 64
    records = {}
    for exact, name in ((True, "segsum_f32"), (False, "segsum_bf16")):
        rec = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
               "replaces": KERNEL_REPLACES, "mode": "exact f32 table"
               if exact else "bf16 table, f32 accumulation",
               "per_direction": {}, "max_abs_err": 0.0}
        totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        for d, n_src in (("u", NUM_ITEMS), ("i", NUM_USERS)):
            src = graphs[f"{d}_src"][0]
            ptr = graphs[f"{d}_ptr"][0]
            n_tgt = ptr.numel() - 1
            n_edges = int(ptr[-1])
            x = torch.randn((n_src, D), generator=gen, device=device)
            out_k = sc.spmm_apply(x, src, ptr, exact)
            # the plain version, summed in f64: the check then measures the
            # kernel's own f32 rounding, not the order of index_add_'s
            # atomics (the f32 plain version is timed and checked too)
            out_p = sc.spmm_apply_plain(x.double(), src, ptr, exact)
            out_p32 = sc.spmm_apply_plain(x, src, ptr, exact)
            torch.cuda.synchronize()
            rtol, atol = seg_tol(ptr)
            err = check_close(out_k, out_p, rtol, atol, f"{name}[{d}]")
            log(f"  plain f32[{d}] vs f64: max abs err "
                f"{max_err(out_p32, out_p):.3e}")
            ms = cuda_ms(lambda: sc.spmm_apply(x, src, ptr, exact))
            plain_ms = cuda_ms(lambda: sc.spmm_apply_plain(x, src, ptr,
                                                           exact))
            # library yardstick: cuSPARSE SpMM on a unit-valued CSR matrix,
            # built outside the timed region (bf16 mode: on the
            # bf16-rounded table held in f32)
            a = torch.sparse_csr_tensor(
                ptr.long(), src[:n_edges].long(),
                torch.ones(n_edges, device=device), size=(n_tgt, n_src),
                check_invariants=False)
            xl = x if exact else x.to(torch.bfloat16).float()
            out_l = torch.sparse.mm(a, xl)
            check_close(out_l, out_p, rtol, atol, f"library[{d}]")
            library_ms = cuda_ms(lambda: torch.sparse.mm(a, xl))
            elem = 4 if exact else 2
            # bytes the function must move: the table once, the ids and
            # row pointers once, the output once
            nbytes = (n_src * D * elem + n_edges * 4 + (n_tgt + 1) * 4
                      + n_tgt * D * 4)
            flops = n_edges * D
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           flops / F32_FLOPS) * 1e3
            max_deg = int((ptr[1:] - ptr[:-1]).max())
            rec["per_direction"][d] = dict(
                num_tgt=n_tgt, num_src=n_src, edges=n_edges, d=D,
                max_degree=max_deg, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                unique_bytes=nbytes, gathered_bytes=n_edges * D * elem,
                max_abs_err=err)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("library_ms", library_ms),
                           ("bound_ms", bound_ms)):
                totals[key] += v
        # an empty interval (all padding) and a graph with empty rows
        x = torch.randn((300, D), generator=gen, device=device)
        empty_ptr = torch.zeros(129, dtype=torch.int32, device=device)
        empty_src = torch.zeros(512, dtype=torch.int32, device=device)
        out = sc.spmm_apply(x, empty_src, empty_ptr, exact)
        torch.cuda.synchronize()
        check(out.shape == (128, D) and not bool(out.any()),
              f"{name}: empty graph must give zeros")
        deg = torch.randint(0, 4, (1000,), generator=gen, device=device)
        deg[::2] = 0
        ptr = torch.zeros(1001, dtype=torch.int32, device=device)
        ptr[1:] = torch.cumsum(deg, 0).to(torch.int32)
        src = torch.randint(0, 300, (int(ptr[-1]) + 40,), generator=gen,
                            device=device, dtype=torch.int32)
        out = sc.spmm_apply(x, src, ptr, exact)
        want = sc.spmm_apply_plain(x.double(), src, ptr, exact)
        torch.cuda.synchronize()
        rtol, atol = seg_tol(ptr)
        err = check_close(out, want, rtol, atol, f"{name}: empty rows")
        check(not bool(out[::2].any()), f"{name}: empty rows must be zero")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec.update(totals)
        rec["bound_by"] = "bytes"
        rec["bound_counts"] = ("bytes: the source table once, the source "
                               "ids and row pointers once, the f32 output "
                               "once, at 3.35e12 B/s; operations: one f32 "
                               "add per gathered value at 67e12 FLOP/s")
        rec["tolerance"] = "rtol 1e-5, atol 1e-5*sqrt(max degree)"
        records[name] = rec
        log(f"{name}: u {rec['per_direction']['u']['ms']:.4f} ms, "
            f"i {rec['per_direction']['i']['ms']:.4f} ms; plain "
            f"{rec['plain_ms']:.4f} ms; library {rec['library_ms']:.4f} ms;"
            f" bound {rec['bound_ms']:.4f} ms; max abs err "
            f"{rec['max_abs_err']:.3e}")
    return records


def bf16_propagation_reference(params, graphs, mc, num_users, num_items):
    """The bf16-table propagation, held hop by hop. A first pass runs the
    kernel path and keeps each hop's input and output; a second pass
    builds the reference chain in f64, where each hop is the plain version
    (the bf16-rounded input summed in f64) of the input the kernel path
    gave that hop. Each hop's kernel output is checked against it at the
    segment-sum tolerance. A reference fed its own f64 chain would round
    some inputs of the next hop to the neighbouring bf16 value and differ
    by a bf16 ulp, not by the kernel's f32 rounding.
    Returns (user_vec, item_vec) of the reference, in f64."""
    from sagnn_tpu_torch.models import selfgnn
    from sagnn_tpu_torch.ops import spmm_cuda as sc

    hops = []

    def record(x, src, ptr, exact):
        out = sc.spmm_apply(x, src, ptr, exact)
        hops.append((x, out))
        return out

    def replay(_x, src, ptr, exact):
        x, got = hops[len(done)]
        want = sc.spmm_apply_plain(x.double(), src, ptr, exact)
        done.append(check_close(got, want, *seg_tol(ptr),
                                f"bf16 hop {len(done)}"))
        return want

    done = []
    p64 = dict(params)
    for key in ("reg/u_embed", "reg/i_embed"):
        p64[key] = p64[key].double()
    kernel = selfgnn.spmm_apply
    try:
        selfgnn.spmm_apply = record
        selfgnn._interval_propagation(params, graphs, mc, num_users,
                                      num_items)
        selfgnn.spmm_apply = replay
        ref = selfgnn._interval_propagation(p64, graphs, mc, num_users,
                                            num_items)
    finally:
        selfgnn.spmm_apply = kernel
    check(len(done) == len(hops) == mc.graph_num * mc.gnn_layer * 2,
          "bf16 reference: every hop replayed")
    return ref


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    from sagnn_tpu_torch.config import PRESETS
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.models.selfgnn import (SelfGNN, _interval_propagation,
                                                _temporal_fusion)
    from sagnn_tpu_torch.ops import _build
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    from sagnn_tpu_torch.serve import Recommender

    # 1. device
    device = torch.device("cuda", 0)
    card = gpu_name_and_power()
    kind = torch.cuda.get_device_name(0)
    log(f"gpu: {card}")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, devices "
        f"{torch.cuda.device_count()}")

    # 2. build
    info = _build.build()
    log(f"build: {info.seconds:.2f} s -> {os.path.relpath(info.path, ROOT)}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")
    _build.load_library()

    # 3. set-up (host)
    base = PRESETS["gowalla"]
    cfg = base.replace(
        model=dataclasses.replace(base.model, spmm_backend="pallas"),
        train=dataclasses.replace(base.train, seed=PARAM_SEED))
    mc = cfg.model
    check((mc.latdim, mc.num_heads, mc.graph_num, mc.gnn_layer,
           mc.att_layer, mc.pos_length, cfg.train.test_size)
          == (64, 16, 3, 2, 1, 200, 1000), "gowalla preset widths")
    t0 = time.perf_counter()
    bundle = synthetic_dataset(num_users=NUM_USERS, num_items=NUM_ITEMS,
                               graph_num=mc.graph_num,
                               test_size=cfg.train.test_size,
                               seed=DATA_SEED, seq_len_range=SEQ_LEN_RANGE)
    t_bundle = time.perf_counter() - t0
    rec = Recommender(cfg, bundle, device=device)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    edges = [m.nnz for m in bundle.sub_mats]
    log(f"set-up: bundle {t_bundle:.1f} s, total {t_setup:.1f} s; "
        f"{NUM_USERS} users x {NUM_ITEMS} items, interval edges {edges}")

    # 4. kernels against their plain versions
    records = kernel_phase(rec.graphs, device)

    # 5. main path: encode through the kernel, counts read just after
    sc.reset_launches()
    fu, fi = rec.encode()
    torch.cuda.synchronize()
    launches_exact = dict(sc.LAUNCHES)
    hops = mc.graph_num * mc.gnn_layer * 2
    log(f"encode launches: {launches_exact}")
    check(launches_exact == {"segsum_f32": hops, "segsum_bf16": 0},
          f"encode must launch segsum_f32 {hops} times")
    check(fu.shape == (NUM_USERS, 64) and fi.shape == (NUM_ITEMS, 64),
          "encoding shapes")
    # the reference: the plain ("xla") backend's propagation summed in f64,
    # then the same fusion stack in f32. The check then measures the
    # kernel's own rounding; the f32 plain backend's rounding (index_add_
    # atomics, in no fixed order) is logged beside it, not checked.
    plain_cfg = dataclasses.replace(mc, spmm_backend="xla")
    plain = SelfGNN(plain_cfg, NUM_USERS, NUM_ITEMS)
    p64 = dict(rec.params)
    for key in ("reg/u_embed", "reg/i_embed"):
        p64[key] = p64[key].double()
    uv64, iv64 = _interval_propagation(p64, rec.graphs, plain_cfg,
                                       NUM_USERS, NUM_ITEMS)
    uv, iv = _interval_propagation(rec.params, rec.graphs, mc, NUM_USERS,
                                   NUM_ITEMS)
    ru, ri = _temporal_fusion(rec.params, uv64.float(), iv64.float(), mc)
    pu, pi, _, _ = plain.encode(rec.params, rec.graphs)
    torch.cuda.synchronize()
    check_close(uv, uv64, 1e-5, 1e-5, "user_vec kernel vs plain f64")
    check_close(iv, iv64, 1e-5, 1e-5, "item_vec kernel vs plain f64")
    err_u = check_close(fu, ru, 1e-4, 1e-5, "final_user kernel vs plain")
    err_i = check_close(fi, ri, 1e-4, 1e-5, "final_item kernel vs plain")
    log(f"encode kernel vs plain backend: max abs err user {err_u:.3e}, "
        f"item {err_i:.3e}; f32 plain backend vs the same reference: user "
        f"{max_err(pu, ru):.3e}, item {max_err(pi, ri):.3e}")
    encode_ms = cuda_ms(rec.encode, iters=5, warmup=1)
    # breakdown: the 12 propagation hops (kernel + leaky-relu + residual
    # adds) alone; the rest of the encode is the fusion stack
    propagation_ms = cuda_ms(
        lambda: _interval_propagation(rec.params, rec.graphs, mc, NUM_USERS,
                                      NUM_ITEMS), iters=5, warmup=1)
    log(f"encode {encode_ms:.3f} ms: propagation {propagation_ms:.3f} ms, "
        f"fusion {encode_ms - propagation_ms:.3f} ms")
    plain_encode_ms = cuda_ms(
        lambda: plain.encode(rec.params, rec.graphs), iters=5, warmup=1)

    users = bundle.tst_usrs[:SERVE_USERS]
    scores, items = rec.recommend(users, k=10, exclude_seen=True)
    torch.cuda.synchronize()
    check(scores.shape == items.shape == (len(users), 10), "top-k shape")
    check(bool(torch.isfinite(scores).all()), "top-k scores finite")
    check(bool((scores[:, :-1] >= scores[:, 1:]).all()), "top-k order")
    items_np = items.cpu().numpy()
    for b, u in enumerate(users):
        seen = set(bundle.sequences[u][-mc.pos_length:])
        check(not seen & set(items_np[b].tolist()), "seen item served")
    recommend_ms = cuda_ms(
        lambda: rec.recommend(users, k=10, exclude_seen=True), iters=10,
        warmup=2)

    metrics = rec.evaluate(max_users=EVAL_USERS)
    evaluate_s = cuda_ms(lambda: rec.evaluate(max_users=EVAL_USERS),
                         iters=1, warmup=1) / 1e3
    for k, v in metrics.items():
        check(math.isfinite(v) and 0.0 <= v <= 1.0, f"metric {k}={v}")
    log(f"evaluate over {min(EVAL_USERS, len(bundle.tst_usrs))} users: "
        f"HR@10 {metrics['HR@10']:.4f} NDCG@10 {metrics['NDCG@10']:.4f} "
        f"(random weights; 10/1000 = 0.01 is chance)")

    # second path: the same encode with the bf16 table
    rec_bf16 = Recommender(
        cfg.replace(model=dataclasses.replace(mc, spmm_exact=False)),
        bundle, rec.params, device=device)
    sc.reset_launches()
    fu16, fi16 = rec_bf16.encode()
    torch.cuda.synchronize()
    launches_bf16 = dict(sc.LAUNCHES)
    log(f"bf16 encode launches: {launches_bf16}")
    check(launches_bf16 == {"segsum_f32": 0, "segsum_bf16": hops},
          f"bf16 encode must launch segsum_bf16 {hops} times")
    # the reference: the plain version on the bf16-rounded hop inputs,
    # summed in f64, then the same fusion stack in f32
    uv16, iv16 = _interval_propagation(rec_bf16.params, rec_bf16.graphs,
                                       rec_bf16.model.cfg, NUM_USERS,
                                       NUM_ITEMS)
    uv16_ref, iv16_ref = bf16_propagation_reference(
        rec_bf16.params, rec_bf16.graphs, rec_bf16.model.cfg, NUM_USERS,
        NUM_ITEMS)
    ru16, ri16 = _temporal_fusion(rec_bf16.params, uv16_ref.float(),
                                  iv16_ref.float(), mc)
    torch.cuda.synchronize()
    check_close(uv16, uv16_ref, 1e-5, 1e-5, "bf16 user_vec kernel vs plain")
    check_close(iv16, iv16_ref, 1e-5, 1e-5, "bf16 item_vec kernel vs plain")
    err16_u = check_close(fu16, ru16, 1e-4, 1e-5,
                          "bf16 final_user kernel vs plain")
    err16_i = check_close(fi16, ri16, 1e-4, 1e-5,
                          "bf16 final_item kernel vs plain")
    bf16_dev = max(max_err(fu16, fu), max_err(fi16, fi))
    bf16_encode_ms = cuda_ms(rec_bf16.encode, iters=5, warmup=1)
    log(f"bf16 encode kernel vs plain: max abs err user {err16_u:.3e}, "
        f"item {err16_i:.3e}; max abs deviation from the exact encode "
        f"{bf16_dev:.3e}")

    records["segsum_f32"]["launches"] = launches_exact["segsum_f32"]
    records["segsum_bf16"]["launches"] = launches_bf16["segsum_bf16"]
    kernels = []
    for r in records.values():
        r["kernel_ms"] = r["ms"]
        r["launches_per_encode"] = r["launches"]
        r["ok"] = True
        r["timed"] = ("ms/plain_ms/library_ms/bound_ms: one user-target "
                      "plus one item-target hop on interval 0")
        kernels.append(r)
    main_path = {
        "card": card, "setup_s": t_setup, "bundle_s": t_bundle,
        "build_s": info.seconds, "encode_ms": encode_ms,
        "propagation_ms": propagation_ms,
        "plain_encode_ms": plain_encode_ms, "bf16_encode_ms": bf16_encode_ms,
        "recommend_ms": recommend_ms, "recommend_users": len(users),
        "evaluate_s": evaluate_s, "evaluate_users": min(
            EVAL_USERS, len(bundle.tst_usrs)), "metrics": metrics,
        "interval_edges": edges, "total_s": time.perf_counter() - t_start}
    log("main_path " + json.dumps(main_path))
    log(card)   # nvidia-smi's name,power.limit line
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
