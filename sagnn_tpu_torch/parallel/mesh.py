"""A ('data', 'model') grid of torch devices; the port of
`sagnn_tpu/parallel/mesh.py`.

The JAX ring is one program that one process drives over a `Mesh` of
devices (shard_map + ppermute over its 'model' axis). Its counterpart here
is a grid of `torch.device`s driven by one process: rank p of the 'model'
axis owns row p of the ring's blocks on `mesh.model_devices[p]`. Without
`devices=` the grid is the visible cards. A grid that names one device
more than once (every rank on `cuda:0`, or on the CPU as the tests run
it) is a mesh too, but only through an explicit `devices=` list: then the
ring's exchanges still copy each block into a new buffer, as a ppermute
always moves data.

A mesh can also span processes (`parallel/launch.global_mesh`): its
'data' axis is then cut into the processes' rows in process order, and
`devices` holds this process's rows only; the 'model' axis stays inside a
process.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch


class Mesh:
    """devices[d][m] is the device of this process's data rank d (global
    rank data_offset + d), model rank m."""

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 process_count: int = 1, process_index: int = 0):
        self.devices = [[torch.device(dv) for dv in row] for row in devices]
        if not self.devices or any(len(row) != len(self.devices[0])
                                   for row in self.devices):
            raise ValueError("a mesh is a non-empty rectangular grid")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process {process_index} of {process_count}")
        self.process_count = process_count
        self.process_index = process_index

    @property
    def shape(self) -> Dict[str, int]:
        """The whole mesh's axes, every process's data ranks counted."""
        return {"data": len(self.devices) * self.process_count,
                "model": len(self.devices[0])}

    @property
    def data_offset(self) -> int:
        """The global data rank of this process's first row."""
        return self.process_index * len(self.devices)

    def row(self, d: int) -> "Mesh":
        """The 1 x model mesh of local data rank d: one model row, as the
        ring runs it."""
        return Mesh([self.devices[d]])

    @property
    def model_devices(self) -> List[torch.device]:
        """The 'model' axis of data rank 0: the ring's ranks in order."""
        return self.devices[0]

    @property
    def device(self) -> torch.device:
        """The first device, where the port keeps what is not sharded."""
        return self.devices[0][0]

    def __repr__(self) -> str:
        procs = (f", process {self.process_index} of {self.process_count}"
                 if self.process_count > 1 else "")
        return f"Mesh({self.shape}, {self.devices}{procs})"


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('data', 'model') mesh, row-major over `devices`.

    devices: default, the visible cards (`cuda:0`, `cuda:1`, ...). data
    defaults to every device on the data axis; data × model must equal
    the number of devices, else ValueError (JAX asserts the same). Without
    a card and without `devices=` there is nothing to build on, and the
    call fails; it never falls back to the CPU."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data is None:
        if model <= 0 or n % model:
            raise ValueError(f"{n} devices do not split into model={model}")
        data = n // model
    if data <= 0 or model <= 0 or data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices (the visible "
                         "cards unless devices= is given)")
    return Mesh([devices[d * model:(d + 1) * model] for d in range(data)])
