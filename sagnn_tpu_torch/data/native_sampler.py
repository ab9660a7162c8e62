"""Build and bind the native C++ batch sampler (`native/sampler.cc`); the
port of `sagnn_tpu/data/native_sampler.py`.

The source is compiled by the host's C++ compiler (g++, or $CXX) at first
use into `sagnn_tpu_torch/build/`, named by a hash of the source, the
flags and the host CPU's feature flags (-march=native builds for this
CPU), so a library from another source or another CPU is never loaded,
and renamed into place atomically, so concurrent first uses (several
processes) never load half a file. A failed build raises. The ctypes
calls release the GIL, so a batch is sampled on a worker thread while
the device runs a step.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import List

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "sampler.cc")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found; the native "
                           "sampler cannot be built")
    return path


def _cpu_flags() -> bytes:
    """The CPU's feature flags as Linux lists them (empty elsewhere)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")),
                        b"")
    except OSError:
        return b""


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_flags())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsagnn_sampler-{h.hexdigest()[:16]}.so")


def build() -> str:
    """The library's path, compiled first unless it exists."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_compiler(), *CXX_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native sampler build failed ({proc.returncode})"
                           f":\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


@functools.cache
def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.sample_train_batch.argtypes = [
        ctypes.c_uint64, i32p, i64, i64, i64p, i32p, i64p, i32p, i32p, i32,
        i32, i32, i32, i32p, i32p, i32p, i32p, f32p, i32p, f32p]
    lib.sample_train_batch.restype = i64
    lib.sample_ssl_batch.argtypes = [
        ctypes.c_uint64, i32p, i64, i64p, i32p, i32, i64, i64, i32p, i32p,
        i32p, i32p, f32p]
    lib.sample_ssl_batch.restype = i64
    return lib


def load_library() -> ctypes.CDLL:
    """The built library with its signatures declared (built on first use;
    raises if it cannot be built or loaded)."""
    return _load(build())


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeSamplerState:
    """Flattened dataset views shared with C++ (built once), in exactly the
    dtypes sampler.cc reads: int64 offsets and row pointers, int32 ids."""

    def __init__(self, sequences: List[List[int]], trn_csr, sub_csrs,
                 tst_int):
        num_users = len(sequences)
        lens = np.array([len(s) for s in sequences], dtype=np.int64)
        self.seq_offsets = np.zeros(num_users + 1, dtype=np.int64)
        np.cumsum(lens, out=self.seq_offsets[1:])
        self.seq_items = np.concatenate(
            [np.asarray(s, dtype=np.int32) if len(s) else
             np.zeros(0, np.int32) for s in sequences]) if num_users else \
            np.zeros(0, np.int32)
        self.trn_indptr = np.ascontiguousarray(trn_csr.indptr,
                                               dtype=np.int64)
        self.trn_indices = np.ascontiguousarray(trn_csr.indices,
                                                dtype=np.int32)
        self.sub_indptr = [np.ascontiguousarray(m.indptr, dtype=np.int64)
                           for m in sub_csrs]
        self.sub_indices = [np.ascontiguousarray(m.indices, dtype=np.int32)
                            for m in sub_csrs]
        self.tst_int = np.array(
            [t if t is not None else -1 for t in tst_int], dtype=np.int32)


def native_train_batch(lib, state: NativeSamplerState, bat_ids: np.ndarray,
                       batch_cap: int, samp_num: int, pred_num: int,
                       pos_length: int, num_items: int, seed: int):
    """(uids, pos_iids, neg_iids, useq_row, pair_mask, seq, mask) of one
    train batch, as the numpy path lays them out."""
    P = batch_cap * samp_num
    uids = np.empty(P, np.int32)
    pos_iids = np.empty(P, np.int32)
    neg_iids = np.empty(P, np.int32)
    useq_row = np.empty(P, np.int32)
    pair_mask = np.empty(P, np.float32)
    seq = np.empty((batch_cap, pos_length), np.int32)
    mask = np.empty((batch_cap, pos_length), np.float32)
    bat = np.ascontiguousarray(bat_ids, dtype=np.int32)
    lib.sample_train_batch(
        seed, _i32p(bat), len(bat), batch_cap, _i64p(state.seq_offsets),
        _i32p(state.seq_items), _i64p(state.trn_indptr),
        _i32p(state.trn_indices), _i32p(state.tst_int), num_items, samp_num,
        pred_num, pos_length, _i32p(uids), _i32p(pos_iids), _i32p(neg_iids),
        _i32p(useq_row), _f32p(pair_mask), _i32p(seq), _f32p(mask))
    return uids, pos_iids, neg_iids, useq_row, pair_mask, seq, mask


def native_ssl_batch(lib, state: NativeSamplerState, k: int,
                     bat_ids: np.ndarray, ssl_num: int, seed: int,
                     col_start: int, col_size: int):
    """Column window [col_start, col_start + col_size) of interval k's SSL
    pair arrays (u_a, i_a, u_b, i_b, mask); the full batch is col_start 0,
    col_size batch * ssl_num."""
    u_a = np.empty(col_size, np.int32)
    i_a = np.empty(col_size, np.int32)
    u_b = np.empty(col_size, np.int32)
    i_b = np.empty(col_size, np.int32)
    m = np.empty(col_size, np.float32)
    bat = np.ascontiguousarray(bat_ids, dtype=np.int32)
    lib.sample_ssl_batch(
        seed, _i32p(bat), len(bat), _i64p(state.sub_indptr[k]),
        _i32p(state.sub_indices[k]), ssl_num, col_start, col_size,
        _i32p(u_a), _i32p(i_a), _i32p(u_b), _i32p(i_b), _f32p(m))
    return u_a, i_a, u_b, i_b, m
