"""Build and bind the port's CUDA kernels; no JAX counterpart (Pallas
kernels are compiled by JAX itself).

The sources under `sagnn_tpu_torch/csrc/` are compiled by `nvcc` into one
shared library with a plain C interface and loaded with `ctypes` (seconds
to build, where a PyTorch C++ extension takes minutes). Each source is
compiled to an object by its own `nvcc`, all started together, and the
objects are linked once. The library goes into `sagnn_tpu_torch/build/`,
named by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one is reused. A failed build raises.

    python -m sagnn_tpu_torch.ops._build [--csrc DIR] [--sass]

builds the library (from DIR's sources, for example another checkout's
`sagnn_tpu_torch/csrc`) and prints one JSON line: each kernel's registers
and spill bytes from ptxas and, with --sass, its global-load instructions
counted in the SASS (`cuobjdump -sass`).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _flags() -> tuple[str, ...]:
    """NVCC_FLAGS and the kernels' schedules and bounds, each defined once
    in the module that sizes its grid and scratch or checks its inputs: the
    segment-sum kernel's and the SDDMM's in `spmm_cuda`, P1's in `probes`,
    the interval attention's in `attention`."""
    from sagnn_tpu_torch.ops import attention, probes
    from sagnn_tpu_torch.ops import spmm_cuda as sc
    return NVCC_FLAGS + (
        f"-DSAGNN_PIECE_ITEMS={sc.PIECE_ITEMS}",
        f"-DSAGNN_WARPS_PER_BLOCK={sc.WARPS_PER_BLOCK}",
        f"-DSAGNN_BLOCKS_PER_SM={sc.BLOCKS_PER_SM}",
        f"-DSAGNN_SDDMM_SPAN={sc.SDDMM_SPAN}",
        f"-DSAGNN_SDDMM_BATCH={sc.SDDMM_BATCH}",
        f"-DSAGNN_SDDMM_WARPS_PER_BLOCK={sc.SDDMM_WARPS_PER_BLOCK}",
        f"-DSAGNN_SDDMM_BLOCKS_PER_SM={sc.SDDMM_BLOCKS_PER_SM}",
        f"-DSAGNN_P1_CHUNK_ROWS={probes.P1_CHUNK_ROWS}",
        f"-DSAGNN_P1_WARPS_PER_BLOCK={probes.P1_WARPS_PER_BLOCK}",
        f"-DSAGNN_MHSA_MAX_NODE_FLOATS={attention.MAX_NODE_FLOATS}")


@dataclass(frozen=True)
class BuildInfo:
    path: str          # the shared library
    seconds: float     # nvcc wall time in this process (0.0 if reused)
    log: str           # nvcc's output (ptxas register/spill report)


def _sources(csrc_dir: str | None = None) -> list[str]:
    csrc_dir = csrc_dir or CSRC_DIR
    return sorted(os.path.join(csrc_dir, f) for f in os.listdir(csrc_dir)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def library_path(csrc_dir: str | None = None) -> str:
    h = hashlib.sha256(" ".join(_flags()).encode())
    for src in _sources(csrc_dir):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsagnn_kernels-{h.hexdigest()[:16]}.so")


@functools.cache
def build(csrc_dir: str | None = None) -> BuildInfo:
    """Compile the kernels (of `csrc_dir`, default CSRC_DIR) unless a
    library for these sources exists."""
    path = library_path(csrc_dir)
    log_path = path + ".log"
    if os.path.isfile(path):
        log = ""
        if os.path.isfile(log_path):
            with open(log_path) as f:
                log = f.read()
        return BuildInfo(path, 0.0, log)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{path}.{os.getpid()}"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources(csrc_dir):
        if not src.endswith(".cu"):
            continue
        obj = f"{tag}.{os.path.basename(src)}.o"
        cmd = [nvcc, *_flags(), "-c", "-o", obj, src]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(obj)
    log = ""
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    tmp = f"{tag}.tmp"
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    seconds = time.perf_counter() - t0
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed))
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, path)  # atomic: concurrent builders never see half a file
    return BuildInfo(path, seconds, log)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with every C entry point's signature declared."""
    lib = ctypes.CDLL(build().path)
    p, i = ctypes.c_void_p, ctypes.c_int
    signatures = {
        # x, src, ptr, out, num_tgt, d, scratch, counters, blocks, device,
        # stream
        tuple(f"sagnn_segsum{mode}_{t}" for t in ("f32", "bf16")
              for mode in ("", "_acc", "_fold", "_fold_acc", "_ablate")):
            [p, p, p, p, i, i, p, p, i, i, p],
        # x, src, n_ids, run, in_flight, vec, lanes, scratch, counter,
        # blocks, out, d, device, stream
        ("sagnn_gather_sum_f32", "sagnn_gather_sum_bf16"):
            [p, p, i, i, i, i, i, p, p, i, p, i, i, p],
        # x, w, src, ptr, out, num_tgt, d, scratch, counters, blocks,
        # device, stream
        ("sagnn_wsegsum_f32", "sagnn_wsegsum_bf16",
         "sagnn_wsegsum_acc_f32"):
            [p, p, p, p, p, i, i, p, p, i, i, p],
        # x, y, src, tgt, ptr, out, num_tgt, num_slots, d, vec, lanes,
        # chunks, blocks, device, stream
        ("sagnn_sddmm_f32", "sagnn_sddmm_bf16"):
            [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p],
        # q, k, v, ctx, n, t, d, head_dim, stable, device, stream
        ("sagnn_interval_mhsa_f32",): [p, p, p, p, i, i, i, i, i, i, p],
        # q, k, v, g, dq, dk, dv, n, t, d, head_dim, stable, device, stream
        ("sagnn_interval_mhsa_bwd_f32",):
            [p, p, p, p, p, p, p, i, i, i, i, i, i, p],
    }
    for names, argtypes in signatures.items():
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i
    lib.sagnn_error_string.argtypes = [i]
    lib.sagnn_error_string.restype = ctypes.c_char_p
    return lib


def ptxas_usage(log: str) -> dict:
    """{kernel (mangled name): {"registers", "spill_stores",
    "spill_loads"}} from nvcc's `-Xptxas -v` output."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            usage[name] = {}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            usage[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            usage[name]["registers"] = int(m.group(1))
    return usage


def sass_global_loads(path: str) -> dict:
    """{kernel (mangled name): number of LDG instructions} in the
    library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    loads, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            loads[name] = 0
        elif name and re.search(r"\bLDG\.", line):
            loads[name] += 1
    return loads


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--csrc", default=None,
                   help="the folder of .cu sources to build")
    p.add_argument("--sass", action="store_true",
                   help="also count each kernel's global loads in the SASS")
    ns = p.parse_args(argv)
    info = build(ns.csrc and os.path.abspath(ns.csrc))
    usage = ptxas_usage(info.log)
    if ns.sass:
        for name, n in sass_global_loads(info.path).items():
            usage.setdefault(name, {})["global_loads"] = n
    print(json.dumps({"library": info.path, "kernels": usage}))


if __name__ == "__main__":
    main()
