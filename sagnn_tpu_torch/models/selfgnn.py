"""SelfGNN inference (encode, score, top-k); the port of the forward and
serving parts of `sagnn_tpu/models/selfgnn.py`.

Parameters are one flat dict of tensors keyed by the JAX param pytree's
paths ("reg/u_embed", "free/seq_mhsa/0/wq", ...), so a JAX pytree, an
`.npz` file and the port's own `init_params` share one layout
(`convert.py`). The registry split is the JAX package's:
  reg/*  — u_embed, i_embed, pos_embed, time_embed, time_fc (Q6), meta2_w,
           meta3_w (the reference's regParams);
  free/* — LSTM, the MHSA kernels/biases, layer norms, meta biases.

Quirks kept (PARITY.md): Q1/Q2 unweighted propagation, Q3 pooled sequence
branch, Q4 shared user/item LSTM, Q5 exp-attention.

Precision: the encode runs in f32 throughout; the entry points turn TF32
off on the card (`device.resolve_device`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sagnn_tpu_torch.config import ModelConfig
from sagnn_tpu_torch.data.graph import IntervalGraphs
from sagnn_tpu_torch.models.layers import leaky_relu, tf_glorot_uniform
from sagnn_tpu_torch.ops.attention import (layer_norm,
                                           multi_head_self_attention)
from sagnn_tpu_torch.ops.chunking import auto_chunk_rows, scatter_local_mask
from sagnn_tpu_torch.ops.lstm import lstm_scan
from sagnn_tpu_torch.ops.segment import propagate
from sagnn_tpu_torch.ops.spmm_cuda import build_stacked_plans, spmm_apply

Params = Dict[str, torch.Tensor]


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


def graphs_to_device(gb: IntervalGraphs, device: torch.device | str
                     ) -> Dict:
    """The padded COO blocks (the "xla" backend's input) and the CSR row
    pointers over them (the "pallas" backend's, with the same source
    ids), as int32 tensors on `device`."""
    plans = build_stacked_plans(gb.u_src, gb.u_tgt, gb.i_src, gb.i_tgt,
                                gb.num_users, gb.num_items)

    def t(a):
        return torch.from_numpy(a).to(device)

    return {
        "u_src": t(gb.u_src), "u_tgt": t(gb.u_tgt),
        "i_src": t(gb.i_src), "i_tgt": t(gb.i_tgt),
        "u_ptr": t(plans["u_ptr"]), "i_ptr": t(plans["i_ptr"]),
    }


def topk_descending(scores: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis, descending (the JAX package's
    approx_max_k at recall_target=1.0 is exact too)."""
    return torch.topk(scores, k, dim=-1, largest=True, sorted=True)


def chunked_topk(queries: torch.Tensor, item_table: torch.Tensor,
                 num_items: int, k: int, chunk_rows: int = 65_536,
                 seen_seq: Optional[torch.Tensor] = None,
                 seen_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k over a catalog too big to score densely: score one
    [B, chunk_rows] block at a time, top-k it, and merge into a running
    top-k with an exact [B, 2k] merge. Exact: the global top-k is a subset
    of the per-chunk top-ks. seen_seq/seen_mask [B, L] exclude each user's
    own items per chunk. Returns (scores [B, k], item_ids [B, k])."""
    if k > num_items:
        raise ValueError(f"k={k} > num_items={num_items}")
    B = queries.shape[0]
    I = item_table.shape[0]
    best_v = torch.full((B, k), float("-inf"), dtype=queries.dtype,
                        device=queries.device)
    best_i = torch.zeros((B, k), dtype=torch.long, device=queries.device)
    for gid0 in range(0, I, chunk_rows):
        chunk = item_table[gid0:gid0 + chunk_rows]
        width = chunk.shape[0]
        scores = queries @ chunk.T                             # [B, width]
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
    return best_v, best_i


def _interval_propagation(params: Params, graphs: Dict, cfg: ModelConfig,
                          num_users: int, num_items: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LightGCN-style propagation per interval (model.py:118-129); JAX
    `_interval_propagation` for the "xla" and unweighted "pallas" backends.
    Returns user_vec [g, U, D], item_vec [g, I, D], the layer-summed
    per-interval node states."""
    def hop(x, side, k, num_tgt):
        """One hop of interval k into the `side` ("u" or "i") targets."""
        if cfg.spmm_backend == "pallas":
            return leaky_relu(spmm_apply(x, graphs[f"{side}_src"][k],
                                         graphs[f"{side}_ptr"][k],
                                         cfg.spmm_exact), cfg.leaky)
        return propagate(x, graphs[f"{side}_src"][k],
                         graphs[f"{side}_tgt"][k], num_tgt, cfg.leaky)

    users, items = [], []
    for k in range(cfg.graph_num):
        embs0 = [params["reg/u_embed"][k]]
        embs1 = [params["reg/i_embed"][k]]
        for _ in range(cfg.gnn_layer):
            a0 = hop(embs1[-1], "u", k, num_users)
            a1 = hop(embs0[-1], "i", k, num_items)
            embs0.append(a0 + embs0[-1])
            embs1.append(a1 + embs1[-1])
        users.append(sum(embs0[1:], embs0[0]))  # tf.add_n over all layers
        items.append(sum(embs1[1:], embs1[0]))
    return torch.stack(users), torch.stack(items)


def _temporal_fusion(params: Params, user_vec: torch.Tensor,
                     item_vec: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared LSTM + interval MHSA + mean (model.py:131-155), inference.
    Returns final_user [U, D], final_item [I, D].

    fusion_chunk_rows > 0 runs the node axis in blocks of that many rows:
    the stack is row-parallel per node, so only one block's LSTM/attention
    temporaries are live at a time. The values equal the unchunked ones."""
    lstm_p = sub(params, "free/lstm")

    def stream(x_t, mhsa_p, ln_p):
        """[n, g, D] -> [n, D]"""
        x_t = lstm_scan(lstm_p, x_t)
        m = multi_head_self_attention(
            mhsa_p, layer_norm(x_t, ln_p["scale"], ln_p["shift"]),
            cfg.num_heads, stable=cfg.stable_softmax)
        return torch.mean(m, dim=1)

    def fuse(vec, mhsa_p, ln_p):
        rows = cfg.fusion_chunk_rows
        n = vec.shape[1]
        if rows <= 0 or n <= rows:
            return stream(vec.transpose(0, 1), mhsa_p, ln_p)
        return torch.cat([stream(vec[:, s:s + rows].transpose(0, 1),
                                 mhsa_p, ln_p)
                          for s in range(0, n, rows)])

    mu = fuse(user_vec, sub(params, "free/mhsa_user"),
              sub(params, "free/ln_user"))
    mi = fuse(item_vec, sub(params, "free/mhsa_item"),
              sub(params, "free/ln_item"))
    return mu, mi


def _sequence_branch(params: Params, item_att_emb: torch.Tensor,
                     seq: torch.Tensor, seq_mask: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Pooled sequence branch, quirk Q3 (model.py:158-167): the mask-matmul
    collapses the sequence to ONE token [B, 1, D] before the attention
    stack. Returns att_user [B, D]."""
    seq_emb = item_att_emb[seq.long()]                          # [B, L, D]
    pos_embed = params["reg/pos_embed"]
    pooled_items = torch.einsum("bl,bld->bd", seq_mask, seq_emb)[:, None]
    pooled_pos = torch.einsum("bl,ld->bd", seq_mask, pos_embed)[:, None]
    ln_item = sub(params, "free/seq_ln_item")
    ln_pos = sub(params, "free/seq_ln_pos")
    x = layer_norm(pooled_items, ln_item["scale"], ln_item["shift"])
    x = x + layer_norm(pooled_pos, ln_pos["scale"], ln_pos["shift"])
    for i in range(cfg.att_layer):
        ln = sub(params, f"free/seq_ln/{i}")
        h = multi_head_self_attention(
            sub(params, f"free/seq_mhsa/{i}"),
            layer_norm(x, ln["scale"], ln["shift"]),
            cfg.num_heads, stable=cfg.stable_softmax)
        x = leaky_relu(h, cfg.leaky) + x  # model.py:166
    return torch.sum(x, dim=1)  # [B, D] (model.py:167)


_NOT_PORTED = (
    ("spmm_backend", lambda c: c.spmm_backend not in ("xla", "pallas"),
     "only 'xla' and 'pallas' are ported ('ring' is multi-device)"),
    ("edge_norm", lambda c: c.edge_norm is not None,
     "weighted propagation is not ported yet"),
    ("edge_attention", lambda c: c.edge_attention,
     "edge attention (SDDMM) is not ported yet"),
    ("per_token_seq_attention", lambda c: c.per_token_seq_attention,
     "per-token sequence attention is not ported yet"),
    ("seq_parallel", lambda c: c.seq_parallel,
     "sequence-parallel attention is not ported yet"),
    ("spmm_src_shard_rows", lambda c: c.spmm_src_shard_rows > 0,
     "source-sharded propagation is not ported yet"),
    ("fusion_dtype", lambda c: c.fusion_dtype != "f32",
     "the port runs the fusion stack in f32 only"),
)


class SelfGNN:
    """Model facade binding a config and graph sizes (JAX `SelfGNN`).

    Graphs are a dict from `graphs_to_device`. Inference only: dropout is
    inactive, as in the JAX package's `encode(train=False)`."""

    def __init__(self, cfg: ModelConfig, num_users: int, num_items: int):
        for name, bad, why in _NOT_PORTED:
            if bad(cfg):
                raise NotImplementedError(f"{name}={getattr(cfg, name)!r}: "
                                          f"{why}")
        self.cfg = cfg
        self.num_users = num_users
        self.num_items = num_items

    def init(self, gen: torch.Generator,
             device: torch.device | str = "cpu") -> Params:
        return init_params(gen, self.cfg, self.num_users, self.num_items,
                           device=device)

    @torch.no_grad()
    def encode(self, params: Params, graphs: Dict):
        """Full-graph encoding. Returns (final_user [U,D], final_item [I,D],
        user_vec [g,U,D], item_vec [g,I,D])."""
        user_vec, item_vec = _interval_propagation(
            params, graphs, self.cfg, self.num_users, self.num_items)
        final_user, final_item = _temporal_fusion(params, user_vec, item_vec,
                                                  self.cfg)
        return final_user, final_item, user_vec, item_vec

    @torch.no_grad()
    def serving_queries(self, params: Params, final_user: torch.Tensor,
                        final_item: torch.Tensor, user_ids: torch.Tensor,
                        seq: torch.Tensor, seq_mask: torch.Tensor
                        ) -> torch.Tensor:
        """Per-user head vector q = final_user[uid] + leakyReLU(att_user)
        [B, D]: both terms of the head (model.py:169-173) dot the same
        final_item row, so scores = q @ final_item^T."""
        att_user = _sequence_branch(params, final_item, seq, seq_mask,
                                    self.cfg)
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
                                    self.cfg)
        pu = final_user[user_ids.long()]                      # [B, D]
        pi = final_item[cand_iids.long()]                     # [B, C, D]
        base = torch.einsum("bd,bcd->bc", pu, pi)
        au = leaky_relu(att_user, self.cfg.leaky)
        return base + torch.einsum("bd,bcd->bc", au, pi)

    @torch.no_grad()
    def recommend_top_k(self, params: Params, graphs: Dict,
                        user_ids: torch.Tensor, seq: torch.Tensor,
                        seq_mask: torch.Tensor, k: int = 10,
                        exclude_seen: bool = True, chunk_rows: int = 0,
                        encodings: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k items over the full catalog for a user batch, optionally
        masking each user's own input sequence. Returns (scores [B, k],
        item_ids [B, k]) descending.

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
        if chunk_rows > 0:
            queries = self.serving_queries(params, final_user, final_item,
                                           user_ids, seq, seq_mask)
            return chunked_topk(queries, final_item, self.num_items, k,
                                chunk_rows, seen_seq, seen_mask)
        scores = self.score_all_items(params, final_user, final_item,
                                      user_ids, seq, seq_mask)
        if exclude_seen:
            seen = scatter_local_mask(seq, 0, self.num_items, valid=seq_mask)
            scores = scores.masked_fill(seen, float("-inf"))
        return topk_descending(scores, k)
