"""Multi-process launch helpers; the port of `sagnn_tpu/parallel/launch.py`.

JAX joins its processes with `jax.distributed.initialize` and builds one
global mesh over every process's devices. The port joins them with
`torch.distributed` over a TCP store:

    from sagnn_tpu_torch.parallel.launch import (initialize_distributed,
                                                 global_mesh)
    initialize_distributed("localhost:29500", num_processes=2,
                           process_id=rank, backend="gloo")
    mesh = global_mesh(model=1, devices=["cpu"])

The 'data' axis spans the processes in process order; the 'model' axis
stays inside a process (`parallel/mesh.py`). Each process samples only the
batch rows its data ranks own (`host_batch_slice`,
`Sampler.train_batch_slice`).

The backend is an explicit argument. gloo runs on the CPU, and on the card
where processes share it (NCCL refuses two ranks on one card); NCCL with
one card per process is not taken up yet (ROADMAP A6(e)). gloo's send
of a CUDA tensor aborts the process (its TCP pair writes from the device
pointer), and its all-reduce of CUDA tensors copies them to the host
itself, so every collective here stages its tensors through host buffers
in one place (`all_reduce_sum`, `send_recv`): that is transport, and the
compute stays on the card.
"""

from __future__ import annotations

import datetime
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from sagnn_tpu_torch.parallel.mesh import Mesh, make_mesh

# all_reduce_sum's calls and host seconds (staging included, the device
# synchronised first), for the multi-process runs' reports
COLLECTIVES = {"calls": 0, "seconds": 0.0}


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "gloo",
                           timeout_s: float = 300.0) -> bool:
    """Join the process group: `coordinator_address` "host:port" of process
    0's TCP store, this process's id among num_processes. Returns False
    (nothing to join) for a single process without an address, True once
    joined (also when already joined)."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and (num_processes or 1) == 1:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("num_processes and process_id are needed with a "
                         "coordinator address")
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """('data', 'model') mesh over every process: this process's `devices`
    (default: the visible cards) as its rows of `model` ranks each, the
    processes' rows in process order along 'data'."""
    local = make_mesh(model=model, devices=devices)
    return Mesh(local.devices, process_count(), process_index())


def host_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this process's rows of a batch split over the
    processes in process order. ValueError unless the batch divides."""
    n, i = process_count(), process_index()
    if global_batch % n:
        raise ValueError(f"batch {global_batch} does not split over {n} "
                         "processes")
    per = global_batch // n
    return i * per, per


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over the processes of each tensor, back on its device, the
    same bits in every process. The tensors are staged in one host buffer
    per dtype and reduced in one collective each. Without a process group,
    the tensors themselves."""
    tensors = list(tensors)
    if process_count() == 1:
        return tensors
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        buf = torch.cat([tensors[i].detach().reshape(-1).cpu()
                         for i in idx])
        dist.all_reduce(buf)
        for i, piece in zip(idx, buf.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = piece.reshape(tensors[i].shape).to(tensors[i].device)
    COLLECTIVES["calls"] += 1
    COLLECTIVES["seconds"] += time.perf_counter() - t0
    return out


def send_recv(block: torch.Tensor, dst: int, src: int) -> torch.Tensor:
    """Send `block` to process `dst` and receive a block of the same shape
    and dtype from process `src`, through host buffers; the received block
    lands on `block`'s device."""
    out = torch.empty(block.shape, dtype=block.dtype)
    staged = block.detach().contiguous().cpu()
    req = dist.isend(staged, dst)
    dist.recv(out, src)
    req.wait()
    return out.to(block.device)
