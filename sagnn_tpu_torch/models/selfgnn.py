"""SelfGNN: training losses, encode, score and top-k; the port of
`sagnn_tpu/models/selfgnn.py` (its single-device paths, the "ring"
backend and seq_parallel over a mesh's model row, and the encode of one
data rank whose node tables are split over its model ranks, with every
option, `SelfGNN.encode_sharded`).

Parameters are one flat dict of tensors keyed by the JAX param pytree's
paths ("reg/u_embed", "free/seq_mhsa/0/wq", ...), so a JAX pytree, an
`.npz` file and the port's own `init_params` share one layout
(`convert.py`). The registry split is the JAX package's:
  reg/*  — u_embed, i_embed, pos_embed, time_embed, time_fc (Q6), meta2_w,
           meta3_w (the reference's regParams);
  free/* — LSTM, the MHSA kernels/biases, layer norms, meta biases.

Quirks kept (PARITY.md): Q1/Q2 unweighted propagation, Q3 pooled sequence
branch, Q4 shared user/item LSTM, Q5 exp-attention. The opt-in variants of
Q1/Q2 are carried too: degree-normalised edge weights (`edge_norm`),
functional edge dropout in training (`edge_dropout_keep`) and GAT-style
edge attention (`edge_attention`), and the one of Q3, masked attention
over every token of the sequence (`per_token_seq_attention`). So are the
options for huge graphs:
source-sharded propagation (`spmm_src_shard_rows`), row-folded gathers
(`spmm_fold_gather`), recomputing propagation and fusion in the backward
(`remat_propagation`) and the node-blocked fusion with one checkpoint per
block (`fusion_chunk_rows`). So is the "ring" backend: propagation edge-
partitioned over a mesh's 'model' axis (`parallel/edge_partition.py`),
and `seq_parallel`: the per-token sequence attention as ring attention
over the model mesh's 'model' axis (`parallel/ring_attention.py`).

Precision: the encode runs in f32 throughout unless asked otherwise; the
entry points turn TF32 off on the card (`device.resolve_device`). The
throughput mode (`--bf16`: spmm_exact=False, fusion_dtype="bf16",
stable_softmax) sums bf16 tables in f32 and runs the fusion stack and the
sequence branch in bf16 with JAX's dtype rules; `chunked_topk` can select
from a bf16 score stream and rerank the winners in f32.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sagnn_tpu_torch.config import ModelConfig
from sagnn_tpu_torch.convert import flatten_tree
from sagnn_tpu_torch.data.graph import (IntervalGraphs, direction_permutation,
                                        edge_weights, inverse_permutation)
from sagnn_tpu_torch.models.layers import (glorot_limit, l2_sum, leaky_relu,
                                          tf_glorot_uniform)
from sagnn_tpu_torch.ops.attention import (layer_norm,
                                           multi_head_self_attention)
from sagnn_tpu_torch.ops.chunking import auto_chunk_rows, scatter_local_mask
from sagnn_tpu_torch.ops.lstm import dropout_keep_mask, lstm_scan
from sagnn_tpu_torch.ops.edge_attention import attention_propagate
from sagnn_tpu_torch.ops.segment import edge_dropout_weights, propagate
from sagnn_tpu_torch.ops.spmm_cuda import (build_stacked_plans,
                                           build_stacked_plans_src_sharded,
                                           spmm, spmm_src_sharded,
                                           spmm_weighted)
from sagnn_tpu_torch.parallel.edge_partition import (ring_spmm,
                                                     ring_spmm_apply_plain,
                                                     shard, unshard)
from sagnn_tpu_torch.parallel.ring_attention import (
    ring_multi_head_self_attention)
from sagnn_tpu_torch.parallel.sharding import (TPGraphs, all_gather,
                                               tp_attention_spmm, tp_spmm,
                                               tp_weighted_spmm)
from sagnn_tpu_torch.utils import jax_random
from sagnn_tpu_torch.utils.profiling import span

Params = Dict[str, torch.Tensor]


@dataclass
class TrainBatch:
    """One training step's host-sampled inputs (ref model.py:252-339); the
    JAX `TrainBatch`, field for field and in the same order. The sampler
    fills it with numpy arrays; `to(device)` gives the tensors the model
    reads.

    P = batch * samp_num BPR pairs; Pssl = batch * ssl_num SSL pairs. The
    SSL pairs are the reference's interleaved layout already split into
    aligned (A, B) halves (model.py:186-202; see the sampler)."""

    uids: Any        # [P] user id per BPR pair
    pos_iids: Any    # [P] positive item
    neg_iids: Any    # [P] negative item
    useq_row: Any    # [P] row into seq/seq_mask for this pair's user
    pair_mask: Any   # [P] 1.0 for real pairs
    seq: Any         # [B, L] right-aligned item sequence (pad 0)
    seq_mask: Any    # [B, L]
    ssl_u_a: Any     # [g, Pssl]
    ssl_i_a: Any     # [g, Pssl]
    ssl_u_b: Any     # [g, Pssl]
    ssl_i_b: Any     # [g, Pssl]
    ssl_mask: Any    # [g, Pssl]

    def to(self, device: torch.device | str) -> "TrainBatch":
        """The same batch as tensors on `device`. A copy from the host to a
        card goes through pinned memory and does not block the host."""
        dev = torch.device(device)

        def move(a):
            t = torch.as_tensor(a)
            if dev.type == "cuda" and t.device.type == "cpu":
                return t.pin_memory().to(dev, non_blocking=True)
            return t.to(dev)

        return TrainBatch(*(move(getattr(self, f.name))
                            for f in dataclasses.fields(self)))


def sub(params: Params, prefix: str) -> Params:
    """The leaves under `prefix/`, keyed by their last path component."""
    p = prefix + "/"
    return {k[len(p):]: v for k, v in params.items() if k.startswith(p)}


def param_shapes(cfg: ModelConfig, num_users: int, num_items: int,
                 max_time: int = 1) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's flat key and shape (JAX `init_params`, :85-118)."""
    g, D = cfg.graph_num, cfg.latdim
    n_prop = g * cfg.gnn_layer * 2  # one throwaway FC per propagate call
    shapes = {
        "reg/u_embed": (g, num_users, D),
        "reg/i_embed": (g, num_items, D),
        "reg/pos_embed": (cfg.pos_length, D),
        "reg/time_embed": (max_time + 1, D),
        "reg/time_fc": (n_prop, D, D),
        "reg/meta2_w": (3 * D, cfg.ssldim),
        "reg/meta3_w": (cfg.ssldim, 1),
        "free/lstm/kernel": (2 * D, 4 * D),
        "free/lstm/bias": (4 * D,),
    }
    mhsa = {"wq": (D, D), "bq": (D,), "wk": (D, D), "bk": (D,),
            "wv": (D, D), "bv": (D,)}
    ln = {"scale": (D,), "shift": (D,)}
    prefixes = [("free/mhsa_user", mhsa), ("free/mhsa_item", mhsa),
                ("free/ln_user", ln), ("free/ln_item", ln),
                ("free/seq_ln_item", ln), ("free/seq_ln_pos", ln)]
    for i in range(cfg.att_layer):
        prefixes += [(f"free/seq_mhsa/{i}", mhsa), (f"free/seq_ln/{i}", ln)]
    for prefix, leaves in prefixes:
        for name, shape in leaves.items():
            shapes[f"{prefix}/{name}"] = shape
    shapes["free/meta2_b"] = (cfg.ssldim,)
    shapes["free/meta3_b"] = (1,)
    return shapes


def reg_loss(params: Params) -> torch.Tensor:
    """Σ ||p||² over the reg/* leaves; args.reg * this is the weight-decay
    part of regLoss (model.py:245)."""
    return l2_sum(v for k, v in sorted(params.items())
                  if k.startswith("reg/"))


def init_params(gen: torch.Generator, cfg: ModelConfig, num_users: int,
                num_items: int, max_time: int = 1,
                device: torch.device | str = "cpu") -> Params:
    """Random parameters with the JAX package's initialisers: TF glorot
    uniform for weights and tables, zeros for biases and shifts, ones for
    layer-norm scales. Draws come from `gen`, in key order."""
    out = {}
    for key, shape in param_shapes(cfg, num_users, num_items,
                                   max_time).items():
        leaf = key.rsplit("/", 1)[1]
        if leaf == "scale":
            out[key] = torch.ones(shape, device=device)
        elif leaf in ("bias", "shift", "bq", "bk", "bv", "meta2_b",
                      "meta3_b"):
            out[key] = torch.zeros(shape, device=device)
        else:
            out[key] = tf_glorot_uniform(gen, shape, device=device)
    return out


def init_params_jax(key: torch.Tensor, cfg: ModelConfig, num_users: int,
                    num_items: int, max_time: int = 1,
                    device: torch.device | str = "cpu") -> Params:
    """The JAX package's `init_params` (selfgnn.py:85-118) from a JAX key
    (`utils/jax_random.py`), draw for draw: the key split into 64, taken in
    JAX's `next(ks)` order (the reg tables and weights, then the LSTM, the
    user and item MHSA and each sequence MHSA, which splits its key in
    three for wq, wk, wv); TF glorot uniform for the reg leaves
    (layers.py:21-33), xavier uniform for the LSTM kernel and the MHSA
    weights (attention.py:23-35, lstm.py:30), zeros and ones where JAX has
    them. The values are JAX's bits, drawn on `device`; the tree goes
    through `convert.flatten_tree` into the port's flat layout."""
    ks = iter(jax_random.split(key, 64))
    g, D = cfg.graph_num, cfg.latdim
    n_prop = g * cfg.gnn_layer * 2

    def uniform(k, shape, limit):
        return jax_random.uniform(k, shape, -limit, limit, device)

    def glorot(shape):
        return uniform(next(ks), shape, glorot_limit(shape))

    def xavier(k, shape):
        return uniform(k, shape, (6.0 / (shape[-2] + shape[-1])) ** 0.5)

    def zeros(n):
        return torch.zeros((n,), device=device)

    def mhsa():
        kq, kk, kv = jax_random.split(next(ks), 3)
        return {"wq": xavier(kq, (D, D)), "bq": zeros(D),
                "wk": xavier(kk, (D, D)), "bk": zeros(D),
                "wv": xavier(kv, (D, D)), "bv": zeros(D)}

    def ln():
        return {"scale": torch.ones((D,), device=device), "shift": zeros(D)}

    reg = {
        "u_embed": glorot((g, num_users, D)),
        "i_embed": glorot((g, num_items, D)),
        "pos_embed": glorot((cfg.pos_length, D)),
        "time_embed": glorot((max_time + 1, D)),
        "time_fc": glorot((n_prop, D, D)),
        "meta2_w": glorot((3 * D, cfg.ssldim)),
        "meta3_w": glorot((cfg.ssldim, 1)),
    }
    free = {
        "lstm": {"kernel": xavier(next(ks), (2 * D, 4 * D)),
                 "bias": zeros(4 * D)},
        "mhsa_user": mhsa(),
        "mhsa_item": mhsa(),
        "ln_user": ln(), "ln_item": ln(),
        "seq_ln_item": ln(), "seq_ln_pos": ln(),
        "seq_mhsa": [mhsa() for _ in range(cfg.att_layer)],
        "seq_ln": [ln() for _ in range(cfg.att_layer)],
        "meta2_b": zeros(cfg.ssldim),
        "meta3_b": zeros(1),
    }
    return flatten_tree({"reg": reg, "free": free})


def graphs_to_device(gb: IntervalGraphs, device: torch.device | str,
                     cfg: Optional[ModelConfig] = None,
                     sub_mats=None) -> Dict:
    """The padded COO blocks (the "xla" backend's input) and the CSR row
    pointers over them (the "pallas" backend's, with the same source
    ids), as int32 tensors on `device`.

    With a `cfg` whose variant needs them (the JAX Trainer's attachments,
    trainer.py:155-233):
      * "plans_ss" (spmm_backend "pallas" with spmm_src_shard_rows > 0):
        the source-sharded plans, {"u_src", "u_ptr", "i_src", "i_ptr"}
        ([g, E] local ids, [g, S, num_tgt + 1] row pointers;
        `ops.spmm_cuda.build_stacked_plans_src_sharded`);
    and, from the interval matrices `sub_mats` the blocks were compiled
    from:
      * "edge_weights" [2, g, E] f32 (cfg.edge_norm): each direction's
        weights in its own COO order (`data.graph.edge_weights`);
      * "i_from_u" and "u_from_i" [g, E] int32 (any weighted variant or
        edge attention): i_from_u[k, j] is the u-direction slot of the
        i-direction slot j (`data.graph.direction_permutation`), u_from_i
        its inverse. A per-edge array in one direction's order takes the
        other's as `a.index_select(0, perm)`: the backward of a weighted
        hop gathers its weights into the transpose plan's order."""
    plans = build_stacked_plans(gb.u_src, gb.u_tgt, gb.i_src, gb.i_tgt,
                                gb.num_users, gb.num_items)

    def t(a):
        return torch.from_numpy(a).to(device)

    out = {
        "u_src": t(gb.u_src), "u_tgt": t(gb.u_tgt),
        "i_src": t(gb.i_src), "i_tgt": t(gb.i_tgt),
        "u_ptr": t(plans["u_ptr"]), "i_ptr": t(plans["i_ptr"]),
    }
    if cfg is not None and _src_sharded(cfg):
        ss = build_stacked_plans_src_sharded(
            gb.u_src, gb.u_tgt, gb.i_src, gb.i_tgt, gb.num_users,
            gb.num_items, cfg.spmm_src_shard_rows)
        out["plans_ss"] = {k: t(v) for k, v in ss.items()}
    if cfg is None or not (_weighted(cfg) or cfg.edge_attention):
        return out
    if sub_mats is None:
        raise ValueError("edge weights and edge attention need the interval "
                         "matrices (sub_mats)")
    i_from_u = direction_permutation(gb, sub_mats)
    out["i_from_u"] = t(i_from_u)
    out["u_from_i"] = t(inverse_permutation(i_from_u))
    if cfg.edge_norm is not None:
        out["edge_weights"] = t(edge_weights(gb, sub_mats, cfg.edge_norm))
    return out


def _src_sharded(cfg: ModelConfig) -> bool:
    """Whether propagation runs source-sharded (K3; "pallas" only, as in
    JAX, selfgnn.py:430)."""
    return cfg.spmm_backend == "pallas" and cfg.spmm_src_shard_rows > 0


def _weighted(cfg: ModelConfig) -> bool:
    """Whether training propagates with per-edge weights (serving too when
    edge_norm is set; edge dropout alone weights training only)."""
    return cfg.edge_norm is not None or cfg.edge_dropout_keep < 1.0


def check_recall_target(recall_target: float) -> None:
    """recall_target must lie in (0, 1], as JAX's approx_max_k requires."""
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target={recall_target} is outside (0, 1]")


def topk_descending(scores: torch.Tensor, k: int,
                    recall_target: float = 1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis, descending (JAX `topk_descending`,
    selfgnn.py:126-140). JAX selects with approx_max_k, which trades
    recall for speed on a TPU only; off the TPU it returns the exact top-k
    at any recall_target, and so does this function (torch.topk).
    recall_target is checked to lie in (0, 1]."""
    check_recall_target(recall_target)
    return torch.topk(scores, k, dim=-1, largest=True, sorted=True)


def chunked_topk(queries: torch.Tensor, item_table: torch.Tensor,
                 num_items: int, k: int, chunk_rows: int = 65_536,
                 recall_target: float = 1.0,
                 seen_seq: Optional[torch.Tensor] = None,
                 seen_mask: Optional[torch.Tensor] = None,
                 score_dtype: Optional[torch.dtype] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k over a catalog too big to score densely (JAX
    `chunked_topk`, selfgnn.py:143-235): score one [B, chunk_rows] block
    at a time, top-k it, and merge into a running top-k with an exact
    [B, 2k] merge. Exact: the global top-k is a subset of the per-chunk
    top-ks (recall_target as in `topk_descending`). seen_seq/seen_mask
    [B, L] exclude each user's own items per chunk.

    score_dtype=torch.bfloat16 casts the queries and each chunk, scores
    and selects from the bf16 stream, then gathers the k winners' rows,
    rescores them in f32 with the f32 queries (winners that were -inf in
    the stream stay -inf: a catalog with fewer than k real candidates) and
    re-sorts: quantised retrieval, exact rerank. The returned scores are
    exact f32; the selection can differ from the exact one only where two
    items' scores agree to bf16 resolution.
    Returns (scores [B, k], item_ids [B, k]) descending."""
    if k > num_items:
        raise ValueError(f"k={k} > num_items={num_items}")
    check_recall_target(recall_target)
    B = queries.shape[0]
    I = item_table.shape[0]
    q_s = queries if score_dtype is None else queries.to(score_dtype)
    best_v = torch.full((B, k), float("-inf"), dtype=q_s.dtype,
                        device=queries.device)
    best_i = torch.zeros((B, k), dtype=torch.long, device=queries.device)
    for gid0 in range(0, I, chunk_rows):
        chunk = item_table[gid0:gid0 + chunk_rows]
        if score_dtype is not None:
            chunk = chunk.to(score_dtype)
        width = chunk.shape[0]
        scores = q_s @ chunk.T                                 # [B, width]
        gids = gid0 + torch.arange(width, device=queries.device)
        scores = torch.where(gids[None, :] < num_items, scores,
                             torch.full_like(scores, float("-inf")))
        if seen_seq is not None:
            seen = scatter_local_mask(seen_seq, gid0, width, valid=seen_mask)
            scores = scores.masked_fill(seen, float("-inf"))
        v, i = torch.topk(scores, min(k, width), dim=-1)
        mv = torch.cat([best_v, v], dim=1)
        mi = torch.cat([best_i, gid0 + i], dim=1)
        best_v, order = torch.topk(mv, k, dim=-1)
        best_i = torch.gather(mi, 1, order)
    if score_dtype is None:
        return best_v, best_i
    exact = torch.einsum("bd,bkd->bk", queries, item_table[best_i])
    exact = exact.masked_fill(torch.isneginf(best_v), float("-inf"))
    vals, order = torch.topk(exact, k, dim=-1)
    return vals, torch.gather(best_i, 1, order)


def _interval_propagation(params: Params, graphs: Dict, cfg: ModelConfig,
                          num_users: int, num_items: int,
                          edge_weights: Optional[Tuple[torch.Tensor,
                                                       torch.Tensor]] = None,
                          mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """LightGCN-style propagation per interval (model.py:118-129); JAX
    `_interval_propagation` for the "xla", "pallas" and "ring" backends,
    unweighted, weighted, with edge attention and source-sharded. Returns
    user_vec [g, U, D], item_vec [g, I, D], the layer-summed per-interval
    node states.

    "ring" (with the model's `mesh`) runs every hop over graphs["ring"]
    (`_ring_interval`).

    Every backend carries gradients: "xla" through autograd of the gather +
    scatter_add_, "pallas" through the kernels' autograd Functions, whose
    backward runs on the other direction's plan of the same interval
    (A_i = A_uᵀ, as JAX pairs fu/fi, selfgnn.py:503-506).

    edge_weights: optional (w_u, w_i), [g, E] each, every direction's
    per-edge weights in its own COO order: the user-target hops take w_u,
    the item-target hops w_i. Default: graphs["edge_weights"] when
    cfg.edge_norm is set, else unweighted. `SelfGNN.encode` passes the
    edge-dropout weights here in training; the tests pass JAX's mask.

    cfg.edge_attention ("pallas" only and without edge weights, as
    `check_ported` holds it): each hop scores its edges from the current
    layer's embeddings (K5), normalises the scores per target (edge
    softmax) and sums with them (K2), in its own direction's edge order.

    cfg.spmm_src_shard_rows > 0 ("pallas", unweighted only, as
    `check_ported` holds it): every hop runs over graphs["plans_ss"], one
    K3 launch per source shard, forward and backward (JAX selfgnn.py:
    430-474). cfg.spmm_fold_gather gathers through the row-folded view
    (K4) in both the sharded and the unsharded unweighted hops.

    cfg.remat_propagation, with autograd on: each interval runs under
    `torch.utils.checkpoint` (non-reentrant), so its backward recomputes
    the interval's hops instead of keeping their g·gnn_layer·2 [N, D]
    activations, as JAX checkpoints the scan body (selfgnn.py:273-276).
    Propagation draws no random numbers (edge-dropout weights come in as
    an argument), so the recompute repeats the forward exactly."""
    with span("sagnn.model.propagation"):
        if cfg.spmm_backend == "ring":
            return _per_interval(params, cfg, _ring_interval(
                graphs["ring"], cfg, num_users, num_items, mesh,
                params["reg/u_embed"].device))
        pallas = cfg.spmm_backend == "pallas"
        sharded = _src_sharded(cfg)
        if edge_weights is None and cfg.edge_norm is not None:
            edge_weights = (graphs["edge_weights"][0],
                            graphs["edge_weights"][1])

        def hop(x, x_tgt, side, k, num_tgt):
            """One hop of interval k into the `side` ("u" or "i")
            targets, from the other side's x; x_tgt is the target side's
            current embedding (read by edge attention only)."""
            other = "i" if side == "u" else "u"
            src, tgt = graphs[f"{side}_src"][k], graphs[f"{side}_tgt"][k]
            w = None if edge_weights is None else \
                edge_weights[0 if side == "u" else 1][k]
            if not pallas:
                return propagate(x, src, tgt, num_tgt, cfg.leaky, w)
            if sharded:
                ss = graphs["plans_ss"]
                agg = spmm_src_sharded(
                    x, ss[f"{side}_src"][k], ss[f"{side}_ptr"][k],
                    ss[f"{other}_src"][k], ss[f"{other}_ptr"][k],
                    cfg.spmm_src_shard_rows, cfg.spmm_exact,
                    cfg.spmm_fold_gather)
                return leaky_relu(agg, cfg.leaky)
            plans = (graphs[f"{side}_ptr"][k], graphs[f"{other}_src"][k],
                     graphs[f"{other}_ptr"][k])
            if cfg.edge_attention:
                agg = attention_propagate(x, x_tgt, src, tgt, *plans,
                                          graphs[f"{other}_from_{side}"][k],
                                          exact=cfg.spmm_exact)
            elif w is not None:
                agg = spmm_weighted(x, w, src, tgt, *plans,
                                    graphs[f"{other}_from_{side}"][k],
                                    cfg.spmm_exact)
            else:
                agg = spmm(x, src, *plans, cfg.spmm_exact,
                           cfg.spmm_fold_gather)
            return leaky_relu(agg, cfg.leaky)

        def interval(k, u0, i0):
            embs0, embs1 = [u0], [i0]
            for _ in range(cfg.gnn_layer):
                a0 = hop(embs1[-1], embs0[-1], "u", k, num_users)
                a1 = hop(embs0[-1], embs1[-1], "i", k, num_items)
                embs0.append(a0 + embs0[-1])
                embs1.append(a1 + embs1[-1])
            # tf.add_n over all layers
            return sum(embs0[1:], embs0[0]), sum(embs1[1:], embs1[0])

        return _per_interval(params, cfg, interval)


def _ring_interval(ring: Dict, cfg: ModelConfig, num_users: int,
                   num_items: int, mesh, device: torch.device):
    """interval(k, u0, i0) of the "ring" backend (JAX selfgnn.py:278-369):
    pad each node table to P·rows rows and split it into the mesh's
    'model' ranks' blocks; every hop is a ring over ring["u"] (user
    targets) or ring["i"], then the leaky-relu and the residual sum per
    block; the layer sums come back to `device`, sliced to the true
    counts. Unweighted and sym_sqrt hops go through K6 (`ring_spmm`,
    backward on the other direction's plan); 'mean' through the plain ring
    (`ring_spmm_apply_plain`, differentiated by autograd), as JAX keeps
    direction-dependent weights off its kernel ring."""
    if mesh is None:
        raise ValueError("spmm_backend='ring' needs the model's mesh")
    pu, pi = ring["u"], ring["i"]
    if (cfg.edge_norm is not None) != (pu.weights is not None):
        raise ValueError(f"edge_norm={cfg.edge_norm!r} but the ring plans "
                         f"{'carry' if pu.weights is not None else 'lack'} "
                         "bucketed weights")
    kernel = cfg.edge_norm != "mean"

    def hop(blocks, k, fwd, bwd):
        agg = (ring_spmm(blocks, fwd, bwd, k, mesh) if kernel
               else ring_spmm_apply_plain(blocks, fwd, k, mesh))
        return [leaky_relu(a, cfg.leaky) for a in agg]

    def interval(k, u0, i0):
        embs0, embs1 = [shard(u0, pu.rows, mesh)], [shard(i0, pi.rows, mesh)]
        for _ in range(cfg.gnn_layer):
            a0 = hop(embs1[-1], k, pu, pi)
            a1 = hop(embs0[-1], k, pi, pu)
            embs0.append([a + e for a, e in zip(a0, embs0[-1])])
            embs1.append([a + e for a, e in zip(a1, embs1[-1])])
        user = [sum(layers[1:], layers[0]) for layers in zip(*embs0)]
        item = [sum(layers[1:], layers[0]) for layers in zip(*embs1)]
        return (unshard(user, num_users, device),
                unshard(item, num_items, device))

    return interval


def _tp_interval_propagation(params: Dict[str, list], tp: TPGraphs,
                             cfg: ModelConfig, masks: "StepMasks"
                             ) -> Tuple[list, list]:
    """`_interval_propagation` of one data rank with the node tables split
    over its model ranks ("xla" and "pallas"; unweighted, weighted, edge
    attention, source-sharded, K4 with spmm_fold_gather): every hop gives
    each model rank the rows it owns, from the source side's shards
    (`parallel/sharding.py`). Returns the per-rank user_vec [g, rows_m, D]
    and item_vec shards.

    remat_propagation, with autograd on: each interval runs under one
    checkpoint around every rank's hops (JAX selfgnn.py:273-276); the
    edge-dropout weights come in with `masks`, drawn outside it."""
    pallas = cfg.spmm_backend == "pallas"
    sharded = _src_sharded(cfg)
    weights = masks.edge_weights
    if weights is None and cfg.edge_norm is not None:
        weights = tuple(tp.graphs[0]["edge_weights"][d] for d in range(2))
    by_dev = {}
    if weights is not None:
        by_dev = {dv: tuple(w.to(dv) for w in weights)
                  for dv in set(tp.devices)}

    def hop(x, x_tgt, side, k):
        """Interval k's hop into the `side` targets from the other side's
        shards x; x_tgt: the target side's shards (edge attention)."""
        d = 0 if side == "u" else 1
        if pallas and (cfg.edge_attention or weights is not None):
            wh = tp.weighted_hop(side, k, cfg.spmm_exact)
            if cfg.edge_attention:
                agg = tp_attention_spmm(x, x_tgt, wh)
            else:
                agg = tp_weighted_spmm(x, [by_dev[r.device][d][k][e0:e1]
                                           for r, (e0, e1) in
                                           zip(wh.fwd, wh.cuts)], wh)
        elif pallas:
            agg = tp_spmm(x, tp.hop(side, k, cfg.spmm_exact,
                                    cfg.spmm_fold_gather,
                                    cfg.spmm_src_shard_rows if sharded
                                    else 0))
        else:
            edges = tp.user_edges if side == "u" else tp.item_edges
            agg = []
            for m, (dv, g, (lo, hi)) in enumerate(zip(
                    tp.devices, tp.graphs, tp.rows(side)[0])):
                e0, e1 = (int(e) for e in edges[k, m])
                w = None if weights is None else by_dev[dv][d][k][e0:e1]
                agg.append(propagate(all_gather(x, dv),
                                     g[f"{side}_src"][k][e0:e1],
                                     g[f"{side}_tgt"][k][e0:e1] - lo,
                                     hi - lo, cfg.leaky, w))
            return agg
        return [leaky_relu(a, cfg.leaky) for a in agg]

    def interval(k, u0, i0):
        embs0, embs1 = [u0], [i0]
        for _ in range(cfg.gnn_layer):
            a0 = hop(embs1[-1], embs0[-1], "u", k)
            a1 = hop(embs0[-1], embs1[-1], "i", k)
            embs0.append([a + e for a, e in zip(a0, embs0[-1])])
            embs1.append([a + e for a, e in zip(a1, embs1[-1])])
        return ([sum(layers[1:], layers[0]) for layers in zip(*embs0)],
                [sum(layers[1:], layers[0]) for layers in zip(*embs1)])

    remat = cfg.remat_propagation and torch.is_grad_enabled()
    users, items = [], []
    for k in range(cfg.graph_num):
        args = (k, [s[k] for s in params["reg/u_embed"]],
                [s[k] for s in params["reg/i_embed"]])
        user, item = (checkpoint(interval, *args, use_reentrant=False,
                                 preserve_rng_state=False)
                      if remat else interval(*args))
        users.append(user)
        items.append(item)
    return ([torch.stack(v) for v in zip(*users)],
            [torch.stack(v) for v in zip(*items)])


def _per_interval(params: Params, cfg: ModelConfig, interval
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """interval(k, u0, i0) for every interval k, stacked; with
    remat_propagation and autograd on, each under its checkpoint."""
    remat = cfg.remat_propagation and torch.is_grad_enabled()
    users, items = [], []
    for k in range(cfg.graph_num):
        args = (k, params["reg/u_embed"][k], params["reg/i_embed"][k])
        user, item = (checkpoint(interval, *args, use_reentrant=False,
                                 preserve_rng_state=False)
                      if remat else interval(*args))
        users.append(user)
        items.append(item)
    return torch.stack(users), torch.stack(items)


def edge_dropout(graphs: Dict, cfg: ModelConfig, gen: torch.Generator
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One training step's edge-dropout weights (w_u, w_i), [g, E] each in
    its direction's own order: a Bernoulli(keep) mask scaled by 1/keep,
    drawn for the user-target direction and then, independently, for the
    item-target one (the reference's two edgeDropout calls,
    model.py:121-122), times the edge_norm weights when set."""
    shape = tuple(graphs["u_src"].shape)
    base = graphs.get("edge_weights")
    return tuple(edge_dropout_weights(gen, shape, cfg.edge_dropout_keep,
                                      None if base is None else base[d])
                 for d in range(2))


def fusion_keep_masks(cfg: ModelConfig, num_users: int, num_items: int,
                      gen: Optional[torch.Generator], device: torch.device
                      ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The LSTM output dropout's keep masks of one training step: [U, g, D]
    for the users, then [I, g, D] for the items, drawn from `gen` on
    `device` (JAX splits its key into ku/ki); None without dropout (no
    generator, or keep_rate 1)."""
    if gen is None or cfg.keep_rate >= 1.0:
        return None
    return tuple(dropout_keep_mask(gen, (n, cfg.graph_num, cfg.latdim),
                                   cfg.keep_rate, device)
                 for n in (num_users, num_items))


@dataclass
class StepMasks:
    """One training step's random draws, in the order the single-device
    step draws them from the dropout generator: the edge-dropout weights
    (w_u, w_i) [g, E] each (`edge_dropout`; None without edge dropout),
    then the LSTM dropout's keep masks [U, g, D] and [I, g, D]
    (`fusion_keep_masks`; None at keep_rate 1). None for both is
    inference."""

    edge_weights: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def to(self, device: torch.device) -> "StepMasks":
        def move(pair):
            return None if pair is None else tuple(t.to(device)
                                                   for t in pair)
        return StepMasks(move(self.edge_weights), move(self.keep))


def draw_step_masks(cfg: ModelConfig, graphs: Dict, num_users: int,
                    num_items: int, gen: Optional[torch.Generator],
                    device: torch.device) -> StepMasks:
    """A training step's StepMasks from `gen` (None: no dropout), the keep
    masks on `device`; `graphs` gives the edge arrays' shape and the
    edge_norm weights the edge-dropout weights multiply."""
    weights = None
    if gen is not None and cfg.edge_dropout_keep < 1.0:
        weights = edge_dropout(graphs, cfg, gen)
    return StepMasks(weights, fusion_keep_masks(cfg, num_users, num_items,
                                                gen, device))


def draw_jax_step_masks(cfg: ModelConfig, graphs: Dict, num_users: int,
                        num_items: int, key: torch.Tensor,
                        device: torch.device) -> StepMasks:
    """A training step's StepMasks as the JAX package draws them from the
    step's key (`utils/jax_random.py`; trainer.py:497): with edge dropout
    the key is split first and the second half split into the user- and
    item-target directions' keys (selfgnn.py:841-845), then the key left
    is split into ku, ki for the LSTM dropout (:599-601). Each is drawn
    with JAX's shapes, on `device`, outside every checkpoint."""
    weights = None
    if cfg.edge_dropout_keep < 1.0:
        key, drop = jax_random.split(key)
        weights = edge_dropout_jax(graphs, cfg, *jax_random.split(drop))
    keep = None
    if cfg.keep_rate < 1.0:
        ku, ki = jax_random.split(key)
        keep = (fusion_keep_mask_jax(cfg, num_users, ku, device),
                fusion_keep_mask_jax(cfg, num_items, ki, device))
    return StepMasks(weights, keep)


def edge_dropout_jax(graphs: Dict, cfg: ModelConfig, ku: torch.Tensor,
                     ki: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`edge_dropout`'s weights from JAX's keys: w * bernoulli(k, keep,
    [g, E]) / keep per direction, w the edge_norm weights or ones
    (trainer.py:163-176, selfgnn.py:268-271), each in its direction's own
    order, as the port's hops take them. "xla" draws each direction's mask
    in that direction's order (selfgnn.py:555-559); "pallas" draws both
    in the user-target order, the canonical one (:524-529), so the
    item-target mask is gathered into its order through graphs'
    i_from_u. The division is by an f32 tensor, as JAX divides, not by
    a reciprocal."""
    src = graphs["u_src"]
    shape, dev = tuple(src.shape), src.device
    base = graphs.get("edge_weights")
    keep = torch.full((), cfg.edge_dropout_keep, dtype=torch.float32,
                      device=dev)
    out = []
    for d, k in enumerate((ku, ki)):
        m = jax_random.bernoulli(k, cfg.edge_dropout_keep, shape, dev)
        if d == 1 and cfg.spmm_backend == "pallas":
            m = torch.gather(m, 1, graphs["i_from_u"].long())
        w = m.to(torch.float32) if base is None else base[d] * m
        out.append(w / keep)
    return tuple(out)


def fusion_keep_mask_jax(cfg: ModelConfig, n: int, key: torch.Tensor,
                         device: torch.device) -> torch.Tensor:
    """One side's LSTM dropout keep mask [n, g, D] from JAX's key for it:
    bernoulli(key, keep_rate, (n, g, D)) when the fusion runs unchunked;
    with fusion_chunk_rows blocks, block i's rows are bernoulli(
    fold_in(key, i), keep_rate, (rows, g, D)) and the remainder block's
    fold_in(key, nb) (JAX selfgnn.py:614-650). The blocks are drawn one
    at a time into one mask, which `_temporal_fusion` cuts at the same
    rows."""
    shape = (cfg.graph_num, cfg.latdim)
    rows = cfg.fusion_chunk_rows
    if rows <= 0 or n <= rows:
        return jax_random.bernoulli(key, cfg.keep_rate, (n, *shape), device)
    out = torch.empty((n, *shape), dtype=torch.bool, device=device)
    for i, lo in enumerate(range(0, n, rows)):
        hi = min(n, lo + rows)
        out[lo:hi] = jax_random.bernoulli(jax_random.fold_in(key, i),
                                          cfg.keep_rate, (hi - lo, *shape),
                                          device)
    return out


def _temporal_fusion(params: Params, user_vec: torch.Tensor,
                     item_vec: torch.Tensor, cfg: ModelConfig,
                     keep: Optional[Tuple[torch.Tensor,
                                          torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared LSTM + interval MHSA + mean (model.py:131-155).
    Returns final_user [U, D], final_item [I, D].

    keep: training only, the LSTM output dropout's masks
    (`fusion_keep_masks`); None is inference (or keep_rate 1).

    fusion_chunk_rows > 0 runs the node axis in blocks of that many rows:
    the stack is row-parallel per node, so only one block's LSTM/attention
    temporaries are live at a time (JAX selfgnn.py:614-653). With autograd
    on, each block runs under its own `torch.utils.checkpoint`, so the
    backward keeps only the states and recomputes the block; a checkpoint
    around all blocks would keep every block's residuals. The blocks are
    views from one `split` of the states, whose backward concatenates the
    blocks' gradients once; a slice per block would make a zero-filled
    full-size gradient per block and add them all. Block b gets rows
    [b·rows, (b+1)·rows) of the one mask drawn for all nodes: from the
    dropout generator it is the mask the unchunked stack would use, so
    chunking changes no value; from JAX's keys (`fusion_keep_mask_jax`)
    each block's rows were drawn from the block index folded into the key,
    as JAX draws them, so the blocks here are JAX's blocks. The caller
    draws the masks outside every checkpoint, because a checkpoint's
    recompute restores only the default generators and would draw other
    masks from an explicit generator.

    fusion_dtype="bf16" runs the stack in bf16 (JAX selfgnn.py:572-653):
    the LSTM, MHSA and layer-norm parameters are cast to bf16 (the f32
    params stay the masters; gradients flow through the casts), each block
    of node states is cast inside its own checkpoint, after the split, so
    no bf16 copy of the whole [N, g, D] stays live, and the stable softmax
    is forced (Q5's raw exp overflows in bf16). PyTorch's bf16 reductions
    accumulate in f32 and round once, as jnp's do (tests/test_torch_bf16.py
    and the card test hold it). The outputs are f32."""
    with span("sagnn.model.fusion"):
        bf16 = cfg.fusion_dtype == "bf16"
        stable = cfg.stable_softmax or bf16

        def cast(p: Params) -> Params:
            return {k: v.to(torch.bfloat16) for k, v in p.items()} if bf16 \
                else p

        lstm_p = cast(sub(params, "free/lstm"))

        def stream(x_t, mhsa_p, ln_p, keep):
            """[n, g, D] -> [n, D] (f32 from a bf16 stack)"""
            if bf16:
                x_t = x_t.to(torch.bfloat16)
            x_t = lstm_scan(lstm_p, x_t, keep_rate=cfg.keep_rate,
                            keep_mask=keep)
            m = multi_head_self_attention(
                mhsa_p, layer_norm(x_t, ln_p["scale"], ln_p["shift"]),
                cfg.num_heads, stable=stable)
            m = torch.mean(m, dim=1)
            return m.float() if bf16 else m

        def fuse(vec, mhsa_p, ln_p, keep):
            rows = cfg.fusion_chunk_rows
            x_t = vec.transpose(0, 1)
            if rows <= 0 or x_t.shape[0] <= rows:
                return stream(x_t, mhsa_p, ln_p, keep)
            blocks = x_t.split(rows)
            keeps = (keep.split(rows) if keep is not None
                     else [None] * len(blocks))
            if not torch.is_grad_enabled():
                return torch.cat([stream(b, mhsa_p, ln_p, k)
                                  for b, k in zip(blocks, keeps)])
            return torch.cat([checkpoint(stream, b, mhsa_p, ln_p, k,
                                         use_reentrant=False,
                                         preserve_rng_state=False)
                              for b, k in zip(blocks, keeps)])

        keep_u, keep_i = (None, None) if keep is None else keep
        mu = fuse(user_vec, cast(sub(params, "free/mhsa_user")),
                  cast(sub(params, "free/ln_user")), keep_u)
        mi = fuse(item_vec, cast(sub(params, "free/mhsa_item")),
                  cast(sub(params, "free/ln_item")), keep_i)
        return mu, mi


def _sequence_branch(params: Params, item_att_emb: torch.Tensor,
                     seq: torch.Tensor, seq_mask: torch.Tensor,
                     cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """Sequence branch (JAX selfgnn.py:656-714). Parity mode replicates
    quirk Q3 (model.py:158-167): the mask-matmul collapses the sequence to
    ONE token [B, 1, D] before the attention stack. With
    cfg.per_token_seq_attention, masked self-attention runs over every
    token of the [B, L, D] sequence instead (the non-parity fix of Q3;
    stable softmax whatever the config says, the masked tokens' logits at
    -1e30) and the tokens are summed under the mask. With cfg.seq_parallel
    on top, each attention layer is ring attention over `mesh`'s 'model'
    axis (one data rank's model row, `parallel/ring_attention.py`), the
    sequence axis split over its ranks; the layer norms and the masked sum
    stay on the inputs' device. Returns att_user [B, D] (f32 from a bf16
    branch).

    fusion_dtype="bf16" runs the branch in bf16: the gathered sequence
    embeddings, the mask, pos_embed and the free parameters are cast, and
    the pooled path's attention takes the stable softmax too. Ring
    attention computes in f32 from the bf16 inputs and returns bf16, as
    JAX's does (ring_attention.py:52)."""
    with span("sagnn.model.sequence"):
        bf16 = cfg.fusion_dtype == "bf16"
        ring = cfg.per_token_seq_attention and cfg.seq_parallel

        def cast(t: torch.Tensor) -> torch.Tensor:
            return t.to(torch.bfloat16) if bf16 else t

        def free(prefix: str) -> Params:
            return {k: cast(v) for k, v in sub(params, prefix).items()}

        seq_emb = cast(rows(item_att_emb, seq))                     # [B, L, D]
        seq_mask = cast(seq_mask)
        pos_embed = cast(params["reg/pos_embed"])
        ln_item, ln_pos = free("free/seq_ln_item"), free("free/seq_ln_pos")

        if cfg.per_token_seq_attention:
            # the layer norm of the positions is the same for every row:
            # computed once, [1, L, D], and broadcast
            x = layer_norm(seq_emb, ln_item["scale"], ln_item["shift"])
            x = x + layer_norm(pos_embed[None], ln_pos["scale"],
                               ln_pos["shift"])
            x = x * seq_mask[:, :, None]
            for i in range(cfg.att_layer):
                ln = free(f"free/seq_ln/{i}")
                xn = layer_norm(x, ln["scale"], ln["shift"])
                with span("sagnn.model.seq_attention"):
                    if ring:
                        h = ring_multi_head_self_attention(
                            mesh, free(f"free/seq_mhsa/{i}"), xn,
                            cfg.num_heads, seq_mask)
                    else:
                        h = multi_head_self_attention(
                            free(f"free/seq_mhsa/{i}"), xn, cfg.num_heads,
                            stable=True, mask=seq_mask)
                x = leaky_relu(h, cfg.leaky) + x
            att = torch.sum(x * seq_mask[:, :, None], dim=1)
        else:
            stable = cfg.stable_softmax or bf16
            pooled_items = torch.einsum("bl,bld->bd", seq_mask,
                                        seq_emb)[:, None]
            pooled_pos = torch.einsum("bl,ld->bd", seq_mask,
                                      pos_embed)[:, None]
            x = layer_norm(pooled_items, ln_item["scale"], ln_item["shift"])
            x = x + layer_norm(pooled_pos, ln_pos["scale"], ln_pos["shift"])
            for i in range(cfg.att_layer):
                ln = free(f"free/seq_ln/{i}")
                h = multi_head_self_attention(
                    free(f"free/seq_mhsa/{i}"),
                    layer_norm(x, ln["scale"], ln["shift"]),
                    cfg.num_heads, stable=stable)
                x = leaky_relu(h, cfg.leaky) + x  # model.py:166
            att = torch.sum(x, dim=1)  # [B, D] (model.py:167)
        return att.float() if bf16 else att


def rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] for a [N, D] table and integer ids of any shape, as an
    embedding lookup. Its backward sums the rows of a repeated id in
    parallel; advanced indexing's backward walks them one after another,
    and a training batch repeats the pad id 0 tens of thousands of times
    (padded sequence slots, SSL pairs past a user's row)."""
    return F.embedding(ids.long(), table)


def _hinge(x: torch.Tensor) -> torch.Tensor:
    """max(0, x) with JAX's gradient: half on each side of a tie."""
    return torch.maximum(x, x.new_zeros(()))


def _ssl_loss(params: Params, batch: TrainBatch, final_user: torch.Tensor,
              final_item: torch.Tensor, user_vec: torch.Tensor,
              item_vec: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Personalized self-augmented loss (model.py:185-204), JAX `_ssl_loss`.

    For each interval k and pair j, with (uA, iA) and (uB, iB) the two
    halves of the reference's interleaved layout:
        S_final = w(uA)·sg(score_long(uA,iA)) − w(uB)·sg(score_long(uB,iB))
        loss   += Σ max(0, 1 − S_final·(score_short_A − score_short_B))
    where score(u,i) = Σ leakyRelu(u_emb ⊙ i_emb), sg is `.detach()` (JAX's
    stop_gradient) and w is the meta-net weight (model.py:178-184),
    computed at the sampled users only (row-wise ops commute with the
    gather, so the values are the reference's). All intervals at once:
    the [g, Pssl] pair arrays index the [g * N, D] tables flattened, at
    row k * N + id for interval k."""
    leaky = cfg.leaky
    g, num_users, d = user_vec.shape
    num_items = item_vec.shape[1]
    k = torch.arange(g, device=user_vec.device)[:, None]
    uv_flat, iv_flat = user_vec.reshape(-1, d), item_vec.reshape(-1, d)
    fu_sg, fi_sg = final_user.detach(), final_item.detach()

    def short_u(u):                                   # user_vec[k, u]
        return rows(uv_flat, k * num_users + u)

    def short_i(i):                                   # item_vec[k, i]
        return rows(iv_flat, k * num_items + i)

    def meta_w(u):                                    # [g, P] -> [g, P]
        fu, uv = rows(final_user, u), short_u(u)
        m1 = torch.cat([fu * uv, fu, uv], dim=-1)
        m2 = leaky_relu(m1 @ params["reg/meta2_w"] + params["free/meta2_b"],
                        leaky)
        return torch.sigmoid(m2 @ params["reg/meta3_w"]
                             + params["free/meta3_b"]).squeeze(-1)

    def score(pu, pi):
        return torch.sum(leaky_relu(pu * pi, leaky), dim=-1)

    ua, ia = batch.ssl_u_a.long(), batch.ssl_i_a.long()
    ub, ib = batch.ssl_u_b.long(), batch.ssl_i_b.long()
    s_final = (meta_w(ua) * score(rows(fu_sg, ua), rows(fi_sg, ia))
               - meta_w(ub) * score(rows(fu_sg, ub), rows(fi_sg, ib)))
    s_short_a = score(short_u(ua), short_i(ia))
    s_short_b = score(short_u(ub), short_i(ib))
    hinge = _hinge(1.0 - s_final * (s_short_a - s_short_b))
    return torch.sum(torch.sum(hinge * batch.ssl_mask, dim=1))


def check_ported(cfg: ModelConfig, train: bool = False,
                 mesh=None) -> None:
    """Raise NotImplementedError for a backend the port does not carry, and
    ValueError for a combination the JAX package refuses too
    (trainer.py:157-201, selfgnn.py:279-280, 436-438): edge attention off
    "pallas" or with edge weights; source sharding with edge weights or
    edge attention, and with train=True also with edge dropout (which
    weights training only); with train=True, edge dropout on the "ring"
    backend, whose weights are bucketed on the host; seq_parallel without
    per_token_seq_attention, and (given a `mesh`, the model's or a
    Trainer's) with a 'model' axis that does not divide pos_length
    (trainer.py:184-193)."""
    if cfg.spmm_backend not in ("xla", "pallas", "ring"):
        raise NotImplementedError(f"spmm_backend={cfg.spmm_backend!r}: the "
                                  "port has the 'xla', 'pallas' and 'ring' "
                                  "backends")
    if cfg.seq_parallel:
        if not cfg.per_token_seq_attention:
            raise ValueError("seq_parallel shards the per-token sequence "
                             "attention; enable per_token_seq_attention")
        if mesh is not None and cfg.pos_length % mesh.shape["model"]:
            raise ValueError(f"pos_length {cfg.pos_length} must divide the "
                             f"'model' axis ({mesh.shape['model']})")
    if cfg.edge_attention:
        if cfg.spmm_backend != "pallas":
            raise ValueError("edge_attention requires spmm_backend='pallas' "
                             "(the SDDMM and weighted segment-sum kernels)")
        if _weighted(cfg):
            raise ValueError("edge_attention is exclusive with edge_norm and "
                             "edge_dropout_keep < 1 (attention is the edge "
                             "weighting)")
    if train and cfg.spmm_backend == "ring" and cfg.edge_dropout_keep < 1.0:
        raise ValueError("edge_dropout_keep < 1 needs the xla or pallas "
                         "backend (the ring's weights are bucketed on the "
                         "host)")
    if _src_sharded(cfg) and (
            cfg.edge_norm is not None or cfg.edge_attention
            or (train and cfg.edge_dropout_keep < 1.0)):
        raise ValueError("spmm_src_shard_rows > 0 supports only unweighted "
                         "parity propagation (no edge_norm/edge_dropout/"
                         "edge_attention)")


class SelfGNN:
    """Model facade binding a config and graph sizes (JAX `SelfGNN`).

    Graphs are a dict from `graphs_to_device` (the "ring" backend's:
    {"ring": `parallel.edge_partition.ring_graphs(...)`}). Serving and
    scoring run under no_grad with dropout off, as the JAX package's
    `encode(train=False)`; `train_losses` carries gradients.

    mesh: a `parallel.mesh.Mesh` of one model row, needed by the "ring"
    backend, whose hops run over its 'model' axis, and by seq_parallel,
    whose ring attention does (JAX asserts the same, selfgnn.py:688)."""

    def __init__(self, cfg: ModelConfig, num_users: int, num_items: int,
                 mesh=None):
        check_ported(cfg, mesh=mesh)
        if cfg.spmm_backend == "ring" and mesh is None:
            raise ValueError("spmm_backend='ring' needs the model's mesh")
        if cfg.seq_parallel and mesh is None:
            raise ValueError("seq_parallel requires a mesh (its ring "
                             "attention runs over the 'model' axis)")
        self.cfg = cfg
        self.num_users = num_users
        self.num_items = num_items
        self.mesh = mesh

    def init(self, gen: torch.Generator,
             device: torch.device | str = "cpu") -> Params:
        return init_params(gen, self.cfg, self.num_users, self.num_items,
                           device=device)

    def encode(self, params: Params, graphs: Dict, train: bool = False,
               gen: Optional[torch.Generator] = None):
        """Full-graph encoding shared by training and serving. Returns
        (final_user [U,D], final_item [I,D], user_vec [g,U,D],
        item_vec [g,I,D]).

        train=False: inference under no_grad, dropout off. train=True: with
        autograd; `gen` (a generator on the params' device; None = no
        dropout) draws the edge-dropout masks when edge_dropout_keep < 1,
        then the LSTM output dropout masks when keep_rate < 1. Both come
        from the one generator that checkpoints carry."""
        if not train:
            with torch.no_grad():
                return self._encode(params, graphs, None)
        check_ported(self.cfg, train=True)
        return self._encode(params, graphs, gen)

    def _encode(self, params, graphs, gen):
        masks = draw_step_masks(self.cfg, graphs, self.num_users,
                                self.num_items, gen,
                                params["reg/u_embed"].device)
        return self.encode_with_masks(params, graphs, masks)

    def encode_with_masks(self, params: Params, graphs: Dict,
                          masks: StepMasks):
        """`encode` with the step's random draws given (`draw_step_masks`;
        an empty StepMasks is the dropout-free encode), under the caller's
        grad mode. The masks are applied outside any checkpoint, so a
        recompute applies the same ones."""
        user_vec, item_vec = _interval_propagation(
            params, graphs, self.cfg, self.num_users, self.num_items,
            masks.edge_weights, mesh=self.mesh)
        args = (params, user_vec, item_vec, self.cfg, masks.keep)
        if (self.cfg.remat_propagation and self.cfg.fusion_chunk_rows <= 0
                and torch.is_grad_enabled()):
            # remat covers the unchunked fusion too (JAX selfgnn.py:850-859):
            # its LSTM/MHSA over every node keeps O(g·N·D) intermediates for
            # the backward. The chunked stack checkpoints each block itself.
            final_user, final_item = checkpoint(
                _temporal_fusion, *args, use_reentrant=False,
                preserve_rng_state=False)
        else:
            final_user, final_item = _temporal_fusion(*args)
        return final_user, final_item, user_vec, item_vec

    def encode_sharded(self, params: Dict[str, list], tp: "TPGraphs",
                       masks: Optional[StepMasks] = None):
        """The encode of one data rank on the "xla" or "pallas" backend with
        the node tables split over its model ranks (`parallel/sharding.py`):
        params maps each key to its shards (the tables' row shards on the
        model ranks' devices, every other leaf one tensor on the rank's
        first device); tp holds the rank's graphs and row bounds; masks as
        in `encode_with_masks` (drawn for the whole tables, each model rank
        takes its rows). Propagation and the fusion stack run on each model
        rank's rows; the results come back whole on the first device, where
        the scoring and SSL gathers read them. Returns `encode`'s four
        tensors, under the caller's grad mode.

        The options act per rank as they act on one device: each rank's
        fusion runs its own rows in fusion_chunk_rows blocks (its keep
        masks cut by its rows, then by the blocks, so the values are the
        single device's) and in bf16 with fusion_dtype="bf16" (cast per
        block, inside the block's checkpoint); with remat_propagation and
        an unchunked fusion each rank's fusion is one checkpoint, as
        `encode_with_masks` checkpoints the whole one."""
        masks = masks or StepMasks()
        cfg = self.cfg
        dev0 = tp.devices[0]
        user_vec, item_vec = _tp_interval_propagation(params, tp, cfg,
                                                      masks)
        free = {k: v[0] for k, v in params.items() if k.startswith("free/")}
        remat = (cfg.remat_propagation and cfg.fusion_chunk_rows <= 0
                 and torch.is_grad_enabled())
        fu, fi = [], []
        for m, dev in enumerate(tp.devices):
            keep = None
            if masks.keep is not None:
                (ulo, uhi), (ilo, ihi) = tp.user_rows[m], tp.item_rows[m]
                keep = (masks.keep[0][ulo:uhi].to(dev),
                        masks.keep[1][ilo:ihi].to(dev))
            args = ({k: v.to(dev) for k, v in free.items()}, user_vec[m],
                    item_vec[m], cfg, keep)
            mu, mi = (checkpoint(_temporal_fusion, *args, use_reentrant=False,
                                 preserve_rng_state=False)
                      if remat else _temporal_fusion(*args))
            fu.append(mu)
            fi.append(mi)
        return (all_gather(fu, dev0), all_gather(fi, dev0),
                torch.cat([v.to(dev0) for v in user_vec], dim=1),
                torch.cat([v.to(dev0) for v in item_vec], dim=1))

    def train_losses(self, params: Params, graphs: Dict, batch: TrainBatch,
                     gen: Optional[torch.Generator] = None,
                     masks: Optional[StepMasks] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        """(preLoss, sslloss, aux{pos_pred, neg_pred}) for one step
        (model.py:241-246), with autograd. `batch` holds tensors on the
        params' device; `gen` as in `encode`, or the step's `masks` drawn
        already (`draw_jax_step_masks`) in its place."""
        if masks is None:
            encodings = self.encode(params, graphs, train=True, gen=gen)
        else:
            check_ported(self.cfg, train=True)
            encodings = self.encode_with_masks(params, graphs, masks)
        hinge, ssl, aux = self.batch_losses(params, batch, *encodings)
        # the reference's reduce_mean over the real pairs (model.py:244)
        pre_loss = hinge / torch.clamp_min(torch.sum(batch.pair_mask), 1.0)
        return pre_loss, ssl, aux

    def batch_losses(self, params: Params, batch: TrainBatch,
                     final_user: torch.Tensor, final_item: torch.Tensor,
                     user_vec: torch.Tensor, item_vec: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        """(Σ hinge over the batch's real pairs, sslloss, aux) from one
        encode's outputs. preLoss is the hinge sum over the real pairs of
        the whole batch: a data rank's share of it divides by the whole
        batch's count (`parallel/distributed.py`); the SSL loss is a sum
        and splits as it is."""
        cfg = self.cfg
        with span("sagnn.model.losses"):
            att_user = _sequence_branch(params, final_item, batch.seq,
                                        batch.seq_mask, cfg, self.mesh)
            pu = rows(final_user, batch.uids)
            au = leaky_relu(rows(att_user, batch.useq_row), cfg.leaky)

            def preds(iids):                          # model.py:169-173
                pi = rows(final_item, iids)       # iEmbed_att == final_item
                return (torch.sum(pu * pi, dim=-1)
                        + torch.sum(au * pi, dim=-1))

            pos = preds(batch.pos_iids)
            neg = preds(batch.neg_iids)
            hinge = _hinge(1.0 - (pos - neg)) * batch.pair_mask
            ssl = _ssl_loss(params, batch, final_user, final_item, user_vec,
                            item_vec, cfg)
            return torch.sum(hinge), ssl, {"pos_pred": pos, "neg_pred": neg}

    @torch.no_grad()
    def serving_queries(self, params: Params, final_user: torch.Tensor,
                        final_item: torch.Tensor, user_ids: torch.Tensor,
                        seq: torch.Tensor, seq_mask: torch.Tensor
                        ) -> torch.Tensor:
        """Per-user head vector q = final_user[uid] + leakyReLU(att_user)
        [B, D]: both terms of the head (model.py:169-173) dot the same
        final_item row, so scores = q @ final_item^T."""
        att_user = _sequence_branch(params, final_item, seq, seq_mask,
                                    self.cfg, self.mesh)
        pu = final_user[user_ids.long()]
        return pu + leaky_relu(att_user, self.cfg.leaky)

    @torch.no_grad()
    def score_all_items(self, params: Params, final_user: torch.Tensor,
                        final_item: torch.Tensor, user_ids: torch.Tensor,
                        seq: torch.Tensor, seq_mask: torch.Tensor
                        ) -> torch.Tensor:
        """Full-catalog scores [B, num_items]."""
        return self.serving_queries(params, final_user, final_item,
                                    user_ids, seq, seq_mask) @ final_item.T

    @torch.no_grad()
    def score_with_encodings(self, params: Params, final_user: torch.Tensor,
                             final_item: torch.Tensor,
                             user_ids: torch.Tensor, cand_iids: torch.Tensor,
                             seq: torch.Tensor, seq_mask: torch.Tensor
                             ) -> torch.Tensor:
        """Candidate scores [B, C] from precomputed encodings (the eval
        path of model.py:169-173 with keepRate=1)."""
        att_user = _sequence_branch(params, final_item, seq, seq_mask,
                                    self.cfg, self.mesh)
        pu = final_user[user_ids.long()]                      # [B, D]
        pi = final_item[cand_iids.long()]                     # [B, C, D]
        base = torch.einsum("bd,bcd->bc", pu, pi)
        au = leaky_relu(att_user, self.cfg.leaky)
        return base + torch.einsum("bd,bcd->bc", au, pi)

    @torch.no_grad()
    def recommend_top_k(self, params: Params, graphs: Dict,
                        user_ids: torch.Tensor, seq: torch.Tensor,
                        seq_mask: torch.Tensor, k: int = 10,
                        exclude_seen: bool = True,
                        recall_target: float = 1.0, chunk_rows: int = 0,
                        encodings: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k items over the full catalog for a user batch, optionally
        masking each user's own input sequence (JAX `recommend_top_k`,
        selfgnn.py:905-949). Returns (scores [B, k], item_ids [B, k])
        descending.

        recall_target: in (0, 1], passed to the top-k, which is exact at
        any value (`topk_descending`).
        chunk_rows: 0 = auto (dense up to 131,072 items, streamed past
        it); -1 = dense; >0 = stream in chunks of this many items.
        encodings: (final_user, final_item) from an earlier `encode`; the
        graph is encoded here when it is None."""
        if encodings is None:
            final_user, final_item, _, _ = self.encode(params, graphs)
        else:
            final_user, final_item = encodings
        if chunk_rows == 0:
            chunk_rows = auto_chunk_rows(self.num_items)
        seen_seq = seq if exclude_seen else None
        seen_mask = seq_mask if exclude_seen else None
        with span("sagnn.serve.score"):
            if chunk_rows > 0:
                # the chunked path scores and selects chunk by chunk
                queries = self.serving_queries(params, final_user,
                                               final_item, user_ids, seq,
                                               seq_mask)
                return chunked_topk(queries, final_item, self.num_items, k,
                                    chunk_rows, recall_target, seen_seq,
                                    seen_mask)
            scores = self.score_all_items(params, final_user, final_item,
                                          user_ids, seq, seq_mask)
            if exclude_seen:
                seen = scatter_local_mask(seq, 0, self.num_items,
                                          valid=seq_mask)
                scores = scores.masked_fill(seen, float("-inf"))
        with span("sagnn.serve.topk"):
            return topk_descending(scores, k, recall_target)
