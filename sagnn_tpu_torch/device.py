"""Device selection for the port's entry points; no JAX counterpart (JAX
picks its backend per process).

Entry points run on the card unless the caller asks for the CPU. On the
card they turn TF32 off for matmuls and cuDNN, because parity with the JAX
package and the TF1 reference needs full f32 (TF32 keeps about three
decimal digits).

`set_blocking_sync` makes the host's waits on the card sleep instead of
spin (`cudaDeviceScheduleBlockingSync`), so that a process blocked on a
hung device op burns no CPU; the supervised training child sets it
(`train/supervisor.py`, `BLOCKING_SYNC_ENV`).
"""

from __future__ import annotations

import ctypes

import torch

# cudaDeviceFlags: the scheduling bits and their values (cuda_runtime_api.h)
SCHEDULE_MASK = 0x07
SCHEDULE_AUTO = 0x00
SCHEDULE_BLOCKING_SYNC = 0x04


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """torch.device for `device`; raises if a CUDA device is asked for and
    absent. Never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _cudart() -> ctypes.CDLL:
    """The CUDA runtime library this process's torch loaded (found in
    /proc/self/maps), so the flags land in the runtime torch calls."""
    torch.cuda.init()
    with open("/proc/self/maps") as f:
        paths = {line.split()[-1] for line in f if "libcudart" in line}
    if len(paths) != 1:
        raise RuntimeError(f"expected one libcudart loaded by torch, found "
                           f"{sorted(paths) or 'none'}")
    lib = ctypes.CDLL(paths.pop())
    lib.cudaGetDeviceFlags.argtypes = [ctypes.POINTER(ctypes.c_uint)]
    lib.cudaGetDeviceFlags.restype = ctypes.c_int
    lib.cudaSetDeviceFlags.argtypes = [ctypes.c_uint]
    lib.cudaSetDeviceFlags.restype = ctypes.c_int
    return lib


def set_blocking_sync(schedule: int = SCHEDULE_BLOCKING_SYNC,
                      index: int = 0) -> int:
    """Set the scheduling flags of card `index` (default: blocking sync,
    whose host waits sleep on an OS primitive; SCHEDULE_AUTO, CUDA's
    default, spins while the process has cores to spare) through
    cudaSetDeviceFlags, read them back and raise unless they are set: a
    caller that asked for blocking waits must not go on spinning. Other
    flag bits are kept. Returns the flags as they were before."""
    lib = _cudart()
    flags = ctypes.c_uint(0)
    with torch.cuda.device(index):
        err = lib.cudaGetDeviceFlags(ctypes.byref(flags))
        if err:
            raise RuntimeError(f"cudaGetDeviceFlags failed: error {err}")
        before = flags.value
        new = (before & ~SCHEDULE_MASK) | schedule
        err = lib.cudaSetDeviceFlags(new)
        if err:
            raise RuntimeError(f"cudaSetDeviceFlags({new:#x}) failed: "
                               f"error {err}")
        err = lib.cudaGetDeviceFlags(ctypes.byref(flags))
    if err or flags.value & SCHEDULE_MASK != schedule:
        raise RuntimeError(f"card {index}: scheduling flags "
                           f"{flags.value:#x} after setting {new:#x} "
                           f"(error {err})")
    return before
