"""Plain PyTorch reference of SelfGNN (SIGIR 2024; the TF1 code at
https://github.com/LIU-YUXI/SA-GNN, model.py), the yardstick that the
benchmark holds the program's outputs to.

Written from the reference model's equations; it imports nothing of the
program and takes nothing that the program made. Float32 throughout, TF32
off unless a caller asks for it (the control).

The parameters are one flat dict keyed as the model's documented layout
("reg/u_embed", "free/seq_mhsa/0/wq", ...); the "reg/" leaves are the
reference's regParams, the rest are free.

Semantics kept from model.py (its quirks included):
  * propagation: an unweighted sum over each interval's distinct
    (user, item) pairs, then leakyReLU, then a residual sum; each interval's
    node states are the sum over the input and every hop (tf.add_n);
  * temporal fusion: one LSTM cell (TF1 BasicLSTMCell, forget bias 1) shared
    by users and items over the intervals, output dropout in training, TF's
    layer norm over intervals and width jointly (eps 1e-12), multi-head
    self-attention with the raw-exp normalisation exp(l) / (sum exp(l) +
    1e-8) and no output projection, the mean over intervals;
  * the sequence branch pools the input sequence to one token (a mask
    matmul) before its attention layers;
  * the BPR-style hinge max(0, 1 - (pos - neg)) averaged over the real
    pairs, the personalised self-augmented SSL hinge weighted by the
    meta-network, reg * sum of squares over the reg leaves;
  * TF1 Adam with the staircase exponential decay.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def set_tf32(on: bool) -> None:
    """TF32 for f32 matrix products and convolutions, on or off."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def param_shapes(m: dict, num_users: int, num_items: int
                 ) -> Dict[str, Tuple[int, ...]]:
    """Every leaf's key and shape for a model config `m` (a configuration
    file's "model" section)."""
    g, D, s = m["graph_num"], m["latdim"], m["ssldim"]
    shapes = {
        "reg/u_embed": (g, num_users, D),
        "reg/i_embed": (g, num_items, D),
        "reg/pos_embed": (m["pos_length"], D),
        "reg/time_embed": (2, D),                 # maxTime 1 (unused)
        "reg/time_fc": (g * m["gnn_layer"] * 2, D, D),   # unused FCs
        "reg/meta2_w": (3 * D, s),
        "reg/meta3_w": (s, 1),
        "free/lstm/kernel": (2 * D, 4 * D),
        "free/lstm/bias": (4 * D,),
    }
    att = {"wq": (D, D), "bq": (D,), "wk": (D, D), "bk": (D,),
           "wv": (D, D), "bv": (D,)}
    norm = {"scale": (D,), "shift": (D,)}
    groups = [("free/mhsa_user", att), ("free/mhsa_item", att),
              ("free/ln_user", norm), ("free/ln_item", norm),
              ("free/seq_ln_item", norm), ("free/seq_ln_pos", norm)]
    for i in range(m["att_layer"]):
        groups += [(f"free/seq_mhsa/{i}", att), (f"free/seq_ln/{i}", norm)]
    for prefix, leaves in groups:
        shapes.update({f"{prefix}/{k}": v for k, v in leaves.items()})
    shapes["free/meta2_b"] = (s,)
    shapes["free/meta3_b"] = (1,)
    return shapes


def init_kind(key: str) -> str:
    """How a leaf starts: "ones" (layer-norm scales), "zeros" (biases and
    shifts) or "glorot" (TF glorot uniform: weights and tables)."""
    leaf = key.rsplit("/", 1)[1]
    if leaf == "scale":
        return "ones"
    if leaf in ("bias", "shift", "bq", "bk", "bv", "meta2_b", "meta3_b"):
        return "zeros"
    return "glorot"


def glorot_bound(shape: Sequence[int]) -> float:
    """TF glorot uniform's bound: the fans of an N-D shape count the
    leading axes as a receptive field."""
    shape = tuple(shape)
    rf = math.prod(shape[:-2]) if len(shape) > 2 else 1
    fan_in = shape[-2] * rf if len(shape) > 1 else shape[0]
    fan_out = shape[-1] * rf
    return math.sqrt(6.0 / (fan_in + fan_out))


@dataclass
class Graph:
    """Each interval's edges on the device: users[k], items[k] [E_k]."""

    users: List[torch.Tensor]
    items: List[torch.Tensor]
    num_users: int
    num_items: int

    @staticmethod
    def from_edges(edges: Sequence[np.ndarray], num_users: int,
                   num_items: int, device) -> "Graph":
        """edges: per interval [2, E_k] (user, item) pairs."""
        return Graph([torch.from_numpy(e[0]).to(device) for e in edges],
                     [torch.from_numpy(e[1]).to(device) for e in edges],
                     num_users, num_items)


def leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def spread(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
           n: int) -> torch.Tensor:
    """out[t] = sum of x[src[e]] over the edges e with dst[e] == t."""
    out = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add(0, dst, x.index_select(0, src))


def joint_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    """tf.contrib.layers.layer_norm's default: moments over every axis but
    the first, scale and shift per last axis, eps 1e-12."""
    dims = tuple(range(1, x.dim()))
    mu = x.mean(dim=dims, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=dims, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-12) * scale + shift


def attention(p: Params, x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, D] -> [B, T, D]: dense Q, K, V with biases, the raw-exp
    normalisation per head, the heads concatenated."""
    B, T, D = x.shape
    dk = D // heads
    q = (x @ p["wq"] + p["bq"]).view(B, T, heads, dk)
    k = (x @ p["wk"] + p["bk"]).view(B, T, heads, dk)
    v = (x @ p["wv"] + p["bv"]).view(B, T, heads, dk)
    e = torch.exp(torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(dk))
    w = e / (e.sum(dim=-1, keepdim=True) + 1e-8)
    return torch.einsum("bhts,bshd->bthd", w, v).reshape(B, T, D)


def lstm(kernel: torch.Tensor, bias: torch.Tensor, x: torch.Tensor
         ) -> torch.Tensor:
    """TF1 BasicLSTMCell over x's second axis: [N, T, D] -> [N, T, H]."""
    N, T, _ = x.shape
    H = kernel.shape[1] // 4
    h = x.new_zeros((N, H))
    c = x.new_zeros((N, H))
    outs = []
    for t in range(T):
        z = torch.cat([x[:, t], h], dim=1) @ kernel + bias
        i, j, f, o = z.split(H, dim=1)
        c = c * torch.sigmoid(f + 1.0) + torch.sigmoid(i) * torch.tanh(j)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1)


def sub(p: Params, prefix: str) -> Params:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix + "/")}


class SelfGNN:
    """The reference model for one configuration and one log's graph."""

    def __init__(self, m: dict, graph: Graph):
        self.m = m
        self.graph = graph

    def propagate(self, p: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each interval's summed node states: [g, U, D], [g, I, D]."""
        m, G = self.m, self.graph
        users, items = [], []
        for k in range(m["graph_num"]):
            u = p["reg/u_embed"][k]
            i = p["reg/i_embed"][k]
            su, si = u, i
            for _ in range(m["gnn_layer"]):
                nu = leaky(spread(i, G.items[k], G.users[k], G.num_users),
                           m["leaky"]) + u
                ni = leaky(spread(u, G.users[k], G.items[k], G.num_items),
                           m["leaky"]) + i
                u, i = nu, ni
                su, si = su + u, si + i
            users.append(su)
            items.append(si)
        return torch.stack(users), torch.stack(items)

    def fuse(self, p: Params, vec: torch.Tensor, side: str,
             keep: Optional[torch.Tensor]) -> torch.Tensor:
        """[g, N, D] -> [N, D]: LSTM over the intervals, output dropout
        where `keep` is given, layer norm, attention, the mean."""
        h = lstm(p["free/lstm/kernel"], p["free/lstm/bias"],
                 vec.transpose(0, 1))
        if keep is not None:
            h = torch.where(keep, h / self.m["keep_rate"], torch.zeros_like(h))
        ln = sub(p, f"free/ln_{side}")
        h = joint_layer_norm(h, ln["scale"], ln["shift"])
        return attention(sub(p, f"free/mhsa_{side}"), h,
                         self.m["num_heads"]).mean(dim=1)

    def encode(self, p: Params, keep: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None):
        """(final_user, final_item, user_vec, item_vec)."""
        uv, iv = self.propagate(p)
        ku, ki = (None, None) if keep is None else keep
        return self.fuse(p, uv, "user", ku), self.fuse(p, iv, "item", ki), \
            uv, iv

    def sequence(self, p: Params, final_item: torch.Tensor,
                 seq: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The sequence branch, [B, D]: the masked sums of the sequence's
        item and position embeddings as one token, then att_layer blocks of
        leakyReLU(attention(layer norm)) + residual, summed over the one
        token."""
        m = self.m
        emb = final_item[seq.long()]                            # [B, L, D]
        pooled = (mask[:, :, None] * emb).sum(dim=1, keepdim=True)
        pos = (mask @ p["reg/pos_embed"])[:, None]
        a, b = sub(p, "free/seq_ln_item"), sub(p, "free/seq_ln_pos")
        x = joint_layer_norm(pooled, a["scale"], a["shift"]) + \
            joint_layer_norm(pos, b["scale"], b["shift"])
        for n in range(m["att_layer"]):
            ln = sub(p, f"free/seq_ln/{n}")
            h = attention(sub(p, f"free/seq_mhsa/{n}"),
                          joint_layer_norm(x, ln["scale"], ln["shift"]),
                          m["num_heads"])
            x = leaky(h, m["leaky"]) + x
        return x.sum(dim=1)

    def queries(self, p: Params, final_user: torch.Tensor,
                final_item: torch.Tensor, users: torch.Tensor,
                seq: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The head's query per user: final_user[u] + leakyReLU(att_u);
        a score is its dot product with an item's final embedding."""
        att = self.sequence(p, final_item, seq, mask)
        return final_user[users.long()] + leaky(att, self.m["leaky"])

    def loss(self, p: Params, batch: Dict[str, torch.Tensor], reg: float,
             ssl_reg: float, keep=None) -> Dict[str, torch.Tensor]:
        """preLoss + reg * sum(reg leaves^2) + ssl_reg * SSL for one batch
        (the sampler's arrays, as tensors)."""
        m = self.m
        fu, fi, uv, iv = self.encode(p, keep)
        att = self.sequence(p, fi, batch["seq"], batch["seq_mask"])
        pu = fu[batch["uids"].long()]
        au = leaky(att[batch["useq_row"].long()], m["leaky"])
        head = pu + au
        pos = (head * fi[batch["pos_iids"].long()]).sum(-1)
        neg = (head * fi[batch["neg_iids"].long()]).sum(-1)
        mask = batch["pair_mask"]
        pre = (torch.relu(1.0 - (pos - neg)) * mask).sum() / \
            torch.clamp(mask.sum(), min=1.0)
        ssl = self.ssl(p, batch, fu, fi, uv, iv)
        l2 = sum((v * v).sum() for k, v in sorted(p.items())
                 if k.startswith("reg/"))
        return {"loss": pre + reg * l2 + ssl_reg * ssl, "preLoss": pre,
                "ssl": ssl}

    def ssl(self, p: Params, batch, fu, fi, uv, iv) -> torch.Tensor:
        """model.py:176-204, interval by interval: the long-term scores
        (stopped gradient) weighted by the meta-network's per-user weight,
        against the interval's short-term score difference."""
        m = self.m
        total = fu.new_zeros(())
        fu_sg, fi_sg = fu.detach(), fi.detach()

        def score(a, b):
            return leaky(a * b, m["leaky"]).sum(-1)

        def weight(k, u):
            f, s = fu[u], uv[k][u]
            h = leaky(torch.cat([f * s, f, s], dim=-1) @ p["reg/meta2_w"]
                      + p["free/meta2_b"], m["leaky"])
            return torch.sigmoid(h @ p["reg/meta3_w"]
                                 + p["free/meta3_b"])[:, 0]

        for k in range(m["graph_num"]):
            ua, ia = batch["ssl_u_a"][k].long(), batch["ssl_i_a"][k].long()
            ub, ib = batch["ssl_u_b"][k].long(), batch["ssl_i_b"][k].long()
            long_term = weight(k, ua) * score(fu_sg[ua], fi_sg[ia]) - \
                weight(k, ub) * score(fu_sg[ub], fi_sg[ib])
            short = score(uv[k][ua], iv[k][ia]) - score(uv[k][ub], iv[k][ib])
            total = total + (torch.relu(1.0 - long_term * short)
                             * batch["ssl_mask"][k]).sum()
        return total


class TF1Adam:
    """TF1's AdamOptimizer under tf.train.exponential_decay(staircase=True):
    the bias corrections fold into the step size, eps sits on the
    uncorrected sqrt(v), the decay reads the step count before the step.
    The step size is worked out in f32, as TF1's scalars are."""

    def __init__(self, lr: float, decay: float, decay_steps: int,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.decay, self.decay_steps = lr, decay, max(1, decay_steps)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m: Params = {}
        self.v: Params = {}
        self.t = 0

    @torch.no_grad()
    def step(self, p: Params, g: Params) -> None:
        f = np.float32
        rate = f(self.lr) * f(self.decay) ** f(self.t // self.decay_steps)
        self.t += 1
        t = f(self.t)
        size = float(rate * np.sqrt(f(1) - f(self.b2) ** t)
                     / (f(1) - f(self.b1) ** t))
        for k, w in p.items():
            if k not in self.m:
                self.m[k] = torch.zeros_like(w)
                self.v[k] = torch.zeros_like(w)
            self.m[k].mul_(self.b1).add_(g[k], alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g[k], g[k], value=1 - self.b2)
            w.sub_(size * self.m[k] / (self.v[k].sqrt() + self.eps))
