"""Sharding rules and the tensor-parallel hop; the port of
`sagnn_tpu/parallel/sharding.py`.

The JAX rules are NamedShardings that GSPMD turns into collectives. Here a
rule is a plain spec, one entry per tensor axis (None, "data" or "model"),
and the helpers below place, split and gather a tensor by it over a
`parallel.mesh.Mesh` that one process drives:
  * TP — the node tables u_embed [g, U, D] and i_embed [g, I, D] split their
    node axis over 'model' (`param_shardings`); model rank m owns rows
    `row_bounds(N, M)[m]`. Every node-wise intermediate (the propagation
    states, the LSTM/attention fusion) keeps that split, so the fusion is
    row-parallel over nodes.
  * DP — a TrainBatch splits its pair arrays [P] and its sequences [B, L]
    on axis 0 over 'data', its SSL arrays [g, Pssl] on axis 1
    (`batch_shardings`, JAX sharding.py:86-115).
  * A replicated leaf (spec ()) is held once per data rank, on the rank's
    first device; a model rank that reads it on another device gets it by
    a copy in the forward, whose backward sums the ranks' gradients back
    into it. Adam's moments mirror the params and the step count is
    replicated (`opt_state_shardings`).

Where JAX shards the [g, E] edge arrays over 'model' and lets XLA insert
the partial sums, the port keeps every data rank's CSR plans whole on each
device and cuts them by target rows: model rank m's hop is the segment sum
over the plan's rows [lo, hi), `ptr[lo:hi + 1]` with the same source ids,
from the source table all-gathered onto its device (`tp_spmm`, K1, or K2
weighted, or K4 folded, one launch per rank and hop). Its gradient is the
same on the transpose plan: the cotangent shards all-gathered, then each
rank sums the transpose plan's rows it owns, which is the reduce-scatter
of the ranks' Aᵀ g without an [N, D] partial per rank. The "xla" backend
takes the same layout with the plain segment sum, differentiated by
autograd (the gradient of the gather's copies is their sum).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sagnn_tpu_torch.ops import spmm_cuda as sc
from sagnn_tpu_torch.parallel.mesh import Mesh

Spec = Tuple[Optional[str], ...]
TABLES = ("reg/u_embed", "reg/i_embed")


# the mesh's axis names, as in JAX's Mesh(devices, ("data", "model"))
DATA = "data"
MODEL = "model"


@dataclass(frozen=True)
class ShardingRules:
    """The rules over one mesh; a spec names the axes DATA and MODEL."""

    mesh: Mesh

    def named(self, *spec: Optional[str]) -> Spec:
        return tuple(spec)

    @property
    def replicated(self) -> Spec:
        return ()


def param_shardings(rules: ShardingRules, params: Dict,
                    split_tables: bool = True) -> Dict[str, Spec]:
    """Each param key's spec: the node tables' node axis over 'model', every
    other leaf replicated (JAX sharding.py:42-54). split_tables=False keeps
    the tables whole too: the "ring" backend splits them itself, hop by
    hop (`parallel/edge_partition.py`)."""
    return {k: rules.named(None, MODEL, None)
            if split_tables and k in TABLES else rules.replicated
            for k in params}


def graph_shardings(rules: ShardingRules, graphs: Dict) -> Dict[str, Spec]:
    """The graphs' specs, descriptive only (nothing places graphs by them):
    the COO blocks, the CSR plans and the per-edge arrays stay whole on
    every device (`graphs_per_row`); the ring's bucket plans are per
    target rank along 'model' already (`RingPlan`)."""
    return {k: rules.named(MODEL) if k == "ring"
            else rules.replicated for k in graphs}


def batch_shardings(rules: ShardingRules, batch):
    """A batch of the same type whose fields are specs: [P] pair arrays and
    [B, L] sequences split axis 0 over 'data', [g, Pssl] SSL arrays axis
    1 (JAX sharding.py:86-115)."""
    specs = {f.name: rules.named(None, DATA) if f.name.startswith("ssl_")
             else rules.named(DATA) for f in dataclasses.fields(batch)}
    return type(batch)(**specs)


def opt_state_shardings(rules: ShardingRules, opt_state, params_sh):
    """Adam's moments mirror the params' specs; the step count is
    replicated (JAX sharding.py:118-136). Descriptive only: `MeshState`
    lays the moments out by the params' specs."""
    return dataclasses.replace(opt_state, mu=dict(params_sh),
                               nu=dict(params_sh), count=rules.replicated)


# -- placement -------------------------------------------------------------------

def row_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """[lo, hi) of each of `parts` ranks over n rows: ceil(n / parts) rows
    each, the last rank the rest (some ranks empty when parts > n)."""
    rows = -(-n // parts)
    return [(min(n, p * rows), min(n, (p + 1) * rows)) for p in range(parts)]


def _axis(spec: Spec, name: str) -> Optional[int]:
    return spec.index(name) if name in spec else None


def place(t: torch.Tensor, spec: Spec, mesh: Mesh) -> List[List[torch.Tensor]]:
    """t laid out by a param spec: per local data rank, the model shards of
    t (split along the spec's 'model' axis, shard m on the rank's device
    m), or for a replicated spec one copy on the rank's first device. Each
    shard is a new tensor."""
    ax = _axis(spec, MODEL)
    out = []
    for row in mesh.devices:
        if ax is None:
            out.append([t.detach().to(row[0], copy=True)])
            continue
        bounds = row_bounds(t.shape[ax], len(row))
        out.append([t.detach().narrow(ax, lo, hi - lo).to(dv, copy=True)
                    for (lo, hi), dv in zip(bounds, row)])
    return out


def gather(shards: Sequence[torch.Tensor], spec: Spec,
           device: torch.device) -> torch.Tensor:
    """One data rank's shards of a tensor laid out by `spec`, whole on
    `device` (the shards themselves when there is one on it)."""
    ax = _axis(spec, MODEL)
    if ax is None or len(shards) == 1:
        return shards[0].to(device)
    return torch.cat([s.to(device) for s in shards], dim=ax)


def split(t, spec: Spec, parts: int) -> list:
    """t (a tensor or numpy array) cut into `parts` equal pieces along the
    spec's 'data' axis (views). ValueError unless the axis divides."""
    ax = _axis(spec, DATA)
    n = t.shape[ax]
    if n % parts:
        raise ValueError(f"axis {ax} of {n} does not split over {parts} "
                         "data ranks")
    size = n // parts
    return [t[(slice(None),) * ax + (slice(p * size, (p + 1) * size),)]
            for p in range(parts)]


def all_gather(shards: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """The model ranks' row shards laid end to end on `device`: a new
    buffer, as a collective always writes one. Differentiable: the
    backward copies each shard's rows of the gradient back to its
    device."""
    return torch.cat([s.to(device) for s in shards])


# -- the tensor-parallel hop -----------------------------------------------------

@dataclass(frozen=True)
class TPGraphs:
    """One data rank's graphs for the tensor-parallel hops: per model rank,
    its device, the graphs on it (`graphs_to_device`'s dict, whole) and the
    user and item rows it owns; for the "xla" backend also the edge range
    [e0, e1) of those rows in each interval's user-target and item-target
    COO, [g, M, 2] each."""

    devices: Tuple[torch.device, ...]
    graphs: Tuple[Dict, ...]
    user_rows: Tuple[Tuple[int, int], ...]
    item_rows: Tuple[Tuple[int, int], ...]
    user_edges: np.ndarray
    item_edges: np.ndarray


def _graphs_by_device(graphs: Dict, mesh: Mesh) -> Dict:
    """`graphs` (on the mesh's first device) and a copy on each other device
    the mesh names, keyed by device."""
    def to(v, dv):
        return {k: to(x, dv) for k, x in v.items()} if isinstance(v, dict) \
            else v.to(dv)

    by_device = {mesh.device: graphs}
    for row in mesh.devices:
        for dv in row:
            if dv not in by_device:
                by_device[dv] = to(graphs, dv)
    return by_device


def graphs_per_row(graphs: Dict, mesh: Mesh, num_users: int,
                   num_items: int) -> list:
    """What each local data rank's "xla" / "pallas" encode reads: with one
    model rank, `graphs` whole on the rank's device (the single-device
    encode, `SelfGNN.encode_with_masks`); with more, its `TPGraphs`."""
    by_device = _graphs_by_device(graphs, mesh)
    if mesh.shape[MODEL] == 1:
        return [by_device[row[0]] for row in mesh.devices]
    return [tp_graphs(by_device, row, num_users, num_items)
            for row in mesh.devices]


def tp_graphs(by_device: Dict[torch.device, Dict],
              devices: Sequence[torch.device], num_users: int,
              num_items: int) -> TPGraphs:
    """The TPGraphs of one data rank whose model ranks sit on `devices`,
    from the graphs on each device (`by_device`)."""
    M = len(devices)
    user_rows = row_bounds(num_users, M)
    item_rows = row_bounds(num_items, M)
    g0 = by_device[devices[0]]

    def edges(ptr, bounds):
        ptr = ptr.cpu().numpy()
        return np.array([[(ptr[k, lo], ptr[k, hi]) for lo, hi in bounds]
                         for k in range(ptr.shape[0])], np.int64)

    return TPGraphs(tuple(devices), tuple(by_device[d] for d in devices),
                    tuple(user_rows), tuple(item_rows),
                    edges(g0["u_ptr"], user_rows),
                    edges(g0["i_ptr"], item_rows))


@dataclass(frozen=True)
class TPRank:
    """One model rank's cut of a hop: its device, the plan's source ids,
    its rows' pointers ptr[lo:hi + 1] and the per-edge weights (whole, in
    the plan's edge order) or None."""

    device: torch.device
    src: torch.Tensor
    ptr: torch.Tensor
    w: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class TPHop:
    """A hop A @ x over the model ranks (`fwd`) and its transpose's cuts
    (`bwd`, the other direction's plan cut by the source rows each rank
    owns, with the forward's weights on each rank's device). to_bwd
    [len(bwd src)] per rank: the forward slot of each transpose slot, which
    gathers the weights into the transpose's order; None unweighted."""

    fwd: Tuple[TPRank, ...]
    bwd: Tuple[TPRank, ...]
    to_bwd: Optional[Tuple[torch.Tensor, ...]]
    exact: bool
    folded: bool

    def run(self, shards: Sequence[torch.Tensor], backward: bool
            ) -> List[torch.Tensor]:
        """Each rank's rows of A @ x (of Aᵀ @ g when backward), [hi - lo,
        D] f32 on its device, from the row shards of x (of g): one segment
        sum launch per rank on the card, the plain version on the CPU."""
        ranks = self.bwd if backward else self.fwd
        out = []
        for p, r in enumerate(ranks):
            x = all_gather([s.contiguous() for s in shards], r.device)
            w = r.w
            if w is not None and backward:
                w = w.index_select(0, self.to_bwd[p])
            if w is None:
                out.append(sc.spmm_apply(x, r.src, r.ptr, self.exact,
                                         folded=self.folded,
                                         backward=backward))
            else:
                out.append(sc.spmm_weighted_apply(x, w, r.src, r.ptr,
                                                  self.exact,
                                                  backward=backward))
        return out


class TPSpmmFunction(torch.autograd.Function):
    """The tensor-parallel hop, differentiable in the source row shards
    (module docstring)."""

    @staticmethod
    def forward(ctx, hop: TPHop, *shards):
        ctx.hop = hop
        return tuple(hop.run(shards, backward=False))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.hop.run(grads, backward=True))


def tp_spmm(shards: Sequence[torch.Tensor], hop: TPHop
            ) -> List[torch.Tensor]:
    """Differentiable A @ x from x's row shards to the target row shards."""
    return list(TPSpmmFunction.apply(hop, *shards))
