"""Interaction logs made from a seed, and the `DatasetBundle` the program
reads.

The generator is a frozen copy of the approach of
`sagnn_tpu_torch/data/synthetic.synthetic_large_dataset` (vectorised: users
uniform, items power-law with a per-user cluster preference, ids scattered
by a permutation, integer timestamps), kept here so that the yardstick does
not move when the program's copy changes. It differs in two ways: every
user's last interaction is held out as its test item (no test negatives
are drawn: no cell evaluates), and the raw arrays are kept, so that the
reference builds its own graphs and sequences from them.

A log file (`benchmark/logs/<name>.json`) holds the parameters; the same
parameters and seed give the same log.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import scipy.sparse as sp


@dataclass
class Log:
    """One interaction log, sorted by user and then by time (stable).

    users, items, times: [n] int64, every interaction; `train` marks all
    but each user's last, which is its held-out test item."""

    num_users: int
    num_items: int
    users: np.ndarray
    items: np.ndarray
    times: np.ndarray
    bounds: np.ndarray      # [U + 1] each user's slice of the arrays
    train: np.ndarray       # [n] bool

    def train_sequence(self, u: int) -> np.ndarray:
        """User u's train items in time order."""
        return self.items[self.bounds[u]:self.bounds[u + 1] - 1]

    def test_items(self) -> np.ndarray:
        """[U] each user's held-out item."""
        return self.items[self.bounds[1:] - 1]

    def intervals(self, graph_num: int) -> np.ndarray:
        """[n_train] the interval of each train interaction: the train
        time range split into `graph_num` equal spans."""
        t = self.times[self.train]
        t_min, t_max = int(t.min()), int(t.max())
        span = max(1, t_max - t_min + 1)
        return np.minimum(((t - t_min) * graph_num) // span, graph_num - 1)


def generate(params: dict, seed: int) -> Log:
    """The log of `params` (a log file's contents) for `seed`."""
    U, I = int(params["num_users"]), int(params["num_items"])
    n = int(params["interactions"])
    rng = np.random.default_rng(int(seed))
    u = rng.integers(0, U, n).astype(np.int64)
    # every user gets at least `per_user_min` interactions: the sampler
    # needs two train items, and one is held out
    u = np.concatenate([u, np.repeat(np.arange(U, dtype=np.int64),
                                     int(params["per_user_min"]))])
    E = len(u)
    base = (I * rng.random(E) ** float(params["item_power"])).astype(np.int64)
    clusters = int(params["clusters"])
    blk = max(1, I // clusters)
    inb = rng.random(E) < float(params["in_cluster"])
    items = np.where(inb, (u % clusters) * blk + base % blk, base)
    items = np.minimum(items, I - 1)
    items = rng.permutation(I).astype(np.int64)[items]
    span = int(params["time_range"])
    t = rng.integers(0, span, E).astype(np.int64)
    order = np.argsort(u * span + t, kind="stable")     # by user, then time
    u, items, t = u[order], items[order], t[order]
    bounds = np.searchsorted(u, np.arange(U + 1))
    train = np.ones(E, dtype=bool)
    train[bounds[1:] - 1] = False
    return Log(U, I, u, items, t, bounds, train)


def bundle(log: Log, graph_num: int):
    """The program's input: a `DatasetBundle` of the log's train
    interactions, split into `graph_num` interval matrices (entries are
    timestamp + 1, duplicates summed, as the reference's preprocessing
    writes them), with every user's held-out item as its test item."""
    from sagnn_tpu_torch.data.io import DatasetBundle

    U, I = log.num_users, log.num_items
    tr_u, tr_i, tr_t = (a[log.train] for a in (log.users, log.items,
                                               log.times))
    trn_mat = sp.csr_matrix((np.ones(len(tr_u), np.int8), (tr_u, tr_i)),
                            shape=(U, I))
    trn_mat.data[:] = 1
    interval = log.intervals(graph_num)
    sub_mats = []
    for k in range(graph_num):
        m = interval == k
        sub_mats.append(sp.csr_matrix((tr_t[m] + 1, (tr_u[m], tr_i[m])),
                                      shape=(U, I)))
    sequences: List[np.ndarray] = [log.train_sequence(x) for x in range(U)]
    tst_int = np.empty(U, dtype=object)
    tst_int[:] = log.test_items().tolist()
    return DatasetBundle(num_users=U, num_items=I, trn_mat=trn_mat,
                         sub_mats=sub_mats, time_mat=None,
                         sequences=sequences, tst_int=tst_int, test_dict={})


def interval_edges(log: Log, graph_num: int) -> List[np.ndarray]:
    """Each interval's distinct (user, item) pairs as [2, E_k] int64, user
    then item, sorted by user and item: the graph the model propagates
    over (a pair seen twice in one interval is one edge)."""
    interval = log.intervals(graph_num)
    tr_u, tr_i = log.users[log.train], log.items[log.train]
    out = []
    for k in range(graph_num):
        m = interval == k
        key = np.unique(tr_u[m] * log.num_items + tr_i[m])
        out.append(np.stack([key // log.num_items, key % log.num_items]))
    return out
