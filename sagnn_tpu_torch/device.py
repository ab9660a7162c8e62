"""Device selection for the port's entry points; no JAX counterpart (JAX
picks its backend per process).

Entry points run on the card unless the caller asks for the CPU. On the
card they turn TF32 off for matmuls and cuDNN, because parity with the JAX
package and the TF1 reference needs full f32 (TF32 keeps about three
decimal digits).
"""

from __future__ import annotations

import torch


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
