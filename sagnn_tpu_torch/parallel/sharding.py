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
of the ranks' Aᵀ g without an [N, D] partial per rank. (`TPGraphs.hop`,
`TPHop`; a weighted hop is `TPGraphs.weighted_hop`, below.) The "xla" backend
takes the same layout with the plain segment sum, differentiated by
autograd (the gradient of the gather's copies is their sum).

The source-sharded hop (`spmm_src_shard_rows`, K3, with K4 when folded)
cuts every source-shard plan by the rank's target rows, ptr[:, lo:hi + 1],
and sums them from the gathered table with one K3 launch per shard; its
backward does the same on the transpose direction's shard plans. A
weighted hop (`TPWeightedHop`: K2 with edge_norm or edge dropout; K5, the
edge softmax and K2 with edge attention) runs on each rank's own edges: a
target-row cut owns the contiguous range [e0, e1) of its direction's edge
order, so the rank sums (and scores and normalises) them from its own
target rows and the gathered sources, in the cut's own slots (src[e0:e1],
tgt[e0:e1] - lo, ptr[lo:hi + 1] - e0), its weights [e1 - e0] tensors,
with gradients under attention. The sources' gradient runs over the
transpose plan, which reads every edge's weight (or score gradient): the
ranks' vectors laid end to end are the whole edge vector (E floats per
hop all-gathered), gathered into the transpose's order.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sagnn_tpu_torch.ops import spmm_cuda as sc
from sagnn_tpu_torch.ops.edge_attention import edge_softmax
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
    user and item rows it owns; and the edge range [e0, e1) of those rows
    in each interval's user-target and item-target COO, [g, M, 2] each
    (what a weighted hop and the "xla" backend cut). Each hop's cuts are
    built on its first use and kept (`hop`, `weighted_hop`): every step
    reuses them."""

    devices: Tuple[torch.device, ...]
    graphs: Tuple[Dict, ...]
    user_rows: Tuple[Tuple[int, int], ...]
    item_rows: Tuple[Tuple[int, int], ...]
    user_edges: np.ndarray
    item_edges: np.ndarray
    _hops: Dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    def rows(self, side: str) -> Tuple[Tuple[Tuple[int, int], ...],
                                       Tuple[Tuple[int, int], ...]]:
        """(target rows, source rows) per rank of the `side` ("u": user
        targets, "i": item targets) hops."""
        return ((self.user_rows, self.item_rows) if side == "u"
                else (self.item_rows, self.user_rows))

    def hop(self, side: str, k: int, exact: bool, folded: bool = False,
            shard_rows: int = 0) -> "TPHop":
        """Interval k's unweighted hop into the `side` targets: each rank's
        rows of the direction's plan (its source-shard plans when
        shard_rows > 0, graphs["plans_ss"]), and of the other direction's
        for the backward."""
        key = ("hop", side, k, exact, folded, shard_rows)
        if key in self._hops:
            return self._hops[key]
        other = "i" if side == "u" else "u"
        tgt_rows, src_rows = self.rows(side)
        plans = self.graphs if shard_rows <= 0 else \
            tuple(g["plans_ss"] for g in self.graphs)

        def ranks(direction, bounds):
            return tuple(TPRank(dv, g[f"{direction}_src"][k],
                                g[f"{direction}_ptr"][k][..., lo:hi + 1])
                         for dv, g, (lo, hi) in zip(self.devices, plans,
                                                    bounds))

        self._hops[key] = TPHop(ranks(side, tgt_rows),
                                ranks(other, src_rows), exact, folded,
                                shard_rows)
        return self._hops[key]

    def weighted_hop(self, side: str, k: int, exact: bool
                     ) -> "TPWeightedHop":
        """Interval k's weighted hop into the `side` targets: each rank's own
        edges of the direction's plan in their own slots, the transpose plan
        cut by each rank's source rows, the cross-direction permutation
        (graphs[f"{other}_from_{side}"])."""
        key = ("weighted", side, k, exact)
        if key in self._hops:
            return self._hops[key]
        other = "i" if side == "u" else "u"
        tgt_rows, src_rows = self.rows(side)
        edges = self.user_edges if side == "u" else self.item_edges
        cuts = tuple((int(e0), int(e1)) for e0, e1 in edges[k])
        fwd = tuple(TPRank(dv, g[f"{side}_src"][k][e0:e1],
                           g[f"{side}_ptr"][k][lo:hi + 1] - e0,
                           g[f"{side}_tgt"][k][e0:e1] - lo)
                    for dv, g, (lo, hi), (e0, e1) in zip(
                        self.devices, self.graphs, tgt_rows, cuts))
        bwd = tuple(TPRank(dv, g[f"{other}_src"][k],
                           g[f"{other}_ptr"][k][lo:hi + 1])
                    for dv, g, (lo, hi) in zip(self.devices, self.graphs,
                                               src_rows))
        self._hops[key] = TPWeightedHop(
            fwd, bwd, tuple(g[f"{other}_from_{side}"][k]
                            for g in self.graphs),
            cuts, self.graphs[0][f"{side}_src"].shape[1], exact)
        return self._hops[key]


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
    """One model rank's cut of a hop: its device, the plan's source ids and
    its rows' pointers ptr[lo:hi + 1] (ptr[:, lo:hi + 1] for a
    source-sharded plan), absolute into the whole src; or, for the forward
    of a weighted hop (`TPWeightedHop.fwd`), its own slots: src[e0:e1],
    ptr[lo:hi + 1] - e0 and the local targets tgt[e0:e1] - lo."""

    device: torch.device
    src: torch.Tensor
    ptr: torch.Tensor
    tgt: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class TPHop:
    """An unweighted hop A @ x over the model ranks (`fwd`) and its
    transpose's cuts (`bwd`, the other direction's plan cut by the source
    rows each rank owns). shard_rows > 0: the plans are source-sharded,
    one K3 launch per shard (`TPGraphs.hop`)."""

    fwd: Tuple[TPRank, ...]
    bwd: Tuple[TPRank, ...]
    exact: bool
    folded: bool
    shard_rows: int = 0

    def run(self, shards: Sequence[torch.Tensor], backward: bool
            ) -> List[torch.Tensor]:
        """Each rank's rows of A @ x (of Aᵀ @ g when backward), [hi - lo,
        D] f32 on its device, from the row shards of x (of g): one segment
        sum launch per rank on the card (one per source shard when
        source-sharded), the plain version on the CPU."""
        out = []
        for r in (self.bwd if backward else self.fwd):
            x = all_gather([s.contiguous() for s in shards], r.device)
            if self.shard_rows > 0:
                out.append(sc.spmm_apply_src_sharded(
                    x, r.src, r.ptr, self.shard_rows, self.exact,
                    self.folded, backward=backward))
            else:
                out.append(sc.spmm_apply(x, r.src, r.ptr, self.exact,
                                         folded=self.folded,
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


# -- the weighted hops: edge weights and edge attention ----------------------------

@dataclass(frozen=True)
class TPWeightedHop:
    """A hop weighted per edge over the model ranks (K2, and K5 for the
    weights' gradient and the attention scores; `TPGraphs.weighted_hop`):
    fwd[m] is rank m's own edges of the direction's plan in their own slots
    (`TPRank` with tgt), cuts[m] = (e0, e1) their range in the direction's
    edge order; bwd[m] the transpose plan cut by the source rows rank m
    owns; to_bwd[m] the forward slot of each transpose slot, on rank m's
    device; `slots` the direction's edge slots E (pads included)."""

    fwd: Tuple[TPRank, ...]
    bwd: Tuple[TPRank, ...]
    to_bwd: Tuple[torch.Tensor, ...]
    cuts: Tuple[Tuple[int, int], ...]
    slots: int
    exact: bool

    def edges(self, parts: Sequence[torch.Tensor],
              device: torch.device) -> torch.Tensor:
        """The ranks' per-edge vectors laid end to end on `device`, zeros on
        the pad slots: the whole [E] vector in the forward order."""
        pad = self.slots - sum(p.numel() for p in parts)
        return torch.cat([p.to(device) for p in parts]
                         + [parts[0].new_zeros(pad, device=device)])

    def transpose(self, tables: Sequence[torch.Tensor],
                  parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each rank's rows of Aᵀ_w @ t [hi - lo, D]: the row shards of t
        (the forward's targets) gathered, the per-edge weights `parts`
        gathered into the transpose's order, one K2 launch per rank counted
        as a backward."""
        out = []
        for r, perm in zip(self.bwd, self.to_bwd):
            t = all_gather([s.contiguous() for s in tables], r.device)
            w = self.edges(parts, r.device).index_select(0, perm)
            out.append(sc.spmm_weighted_apply(t, w, r.src, r.ptr, self.exact,
                                              backward=True))
        return out


class TPSddmmFunction(torch.autograd.Function):
    """Each rank's edge scores s[e] = x[src[e]]·y[tgt[e]] [e1 - e0] from x's
    row shards (gathered) and its own target rows of y, differentiable in
    both (`ops.spmm_cuda.SddmmFunction` per rank): dy is K2 on the rank's
    own slots, dx K2 on the transpose plan (`TPWeightedHop.transpose`)."""

    @staticmethod
    def forward(ctx, hop: TPWeightedHop, *shards):
        M = len(hop.fwd)
        xs, ys = shards[:M], shards[M:]
        ctx.hop = hop
        ctx.save_for_backward(*xs, *ys)
        return tuple(sc.sddmm_apply(all_gather(xs, r.device), y.contiguous(),
                                    r.src, r.tgt, r.ptr, hop.exact)
                     for r, y in zip(hop.fwd, ys))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        hop = ctx.hop
        M = len(hop.fwd)
        saved = ctx.saved_tensors
        xs, ys = saved[:M], saved[M:]
        grads = [g.contiguous() for g in grads]
        dxs = hop.transpose(ys, grads)
        dys = [sc.spmm_weighted_apply(all_gather(xs, r.device), g, r.src,
                                      r.ptr, hop.exact, backward=True)
               for r, g in zip(hop.fwd, grads)]
        return (None,) + tuple(dxs) + tuple(dys)


class TPSpmmWeightedFunction(torch.autograd.Function):
    """Each rank's rows of A_w @ x [hi - lo, D] from x's row shards and its
    own edges' weights [e1 - e0], differentiable in both
    (`ops.spmm_cuda.SpmmWeightedFunction` per rank): dx is K2 on the
    transpose plan with every rank's weights; dw, K5 of the rank's
    cotangent rows against the gathered sources, is launched only when the
    weights need a gradient (edge attention's; edge_norm's and edge
    dropout's are constants)."""

    @staticmethod
    def forward(ctx, hop: TPWeightedHop, *args):
        M = len(hop.fwd)
        xs, ws = args[:M], args[M:]
        ctx.hop = hop
        ctx.save_for_backward(*xs, *ws)
        return tuple(sc.spmm_weighted_apply(all_gather(xs, r.device),
                                            w.contiguous(), r.src, r.ptr,
                                            hop.exact)
                     for r, w in zip(hop.fwd, ws))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        hop = ctx.hop
        M = len(hop.fwd)
        saved = ctx.saved_tensors
        xs, ws = saved[:M], saved[M:]
        grads = [g.contiguous() for g in grads]
        dxs = hop.transpose(grads, ws) if any(ctx.needs_input_grad[1:M + 1]) \
            else [None] * M
        dws = [sc.sddmm_apply(all_gather(xs, r.device), g, r.src, r.tgt,
                              r.ptr, hop.exact, backward=True)
               for r, g in zip(hop.fwd, grads)] \
            if any(ctx.needs_input_grad[M + 1:]) else [None] * M
        return (None,) + tuple(dxs) + tuple(dws)


def tp_weighted_spmm(shards: Sequence[torch.Tensor],
                     weights: Sequence[torch.Tensor], hop: TPWeightedHop
                     ) -> List[torch.Tensor]:
    """Differentiable A_w @ x from x's row shards and each rank's own
    edges' weights (`TPSpmmWeightedFunction`)."""
    return list(TPSpmmWeightedFunction.apply(hop, *shards, *weights))


def tp_attention_spmm(x_src: Sequence[torch.Tensor],
                      x_tgt: Sequence[torch.Tensor], hop: TPWeightedHop
                      ) -> List[torch.Tensor]:
    """The edge-attention hop over the model ranks (`ops.edge_attention.
    attention_propagate` per rank): each rank scores its own edges from
    the gathered sources x_src and its target rows x_tgt (K5), scaled by
    1/sqrt(D), normalises them per target (the edge softmax, plain
    PyTorch) and sums its rows with them (K2). Differentiable in both
    tables' shards."""
    temp = float(x_src[0].shape[-1]) ** 0.5
    scores = TPSddmmFunction.apply(hop, *x_src, *x_tgt)
    w = [edge_softmax(s / temp, r.tgt, r.ptr)
         for s, r in zip(scores, hop.fwd)]
    return tp_weighted_spmm(x_src, w, hop)
