"""Synthetic temporal bipartite datasets; the port's copy of
`sagnn_tpu/data/synthetic.py`: `synthetic_dataset`, the streaming COO
generator `synthetic_edges` with `synthetic_interval_mats`, and
`synthetic_large_dataset` (its own draws, not the stream's).

Each generator draws from one numpy `Generator` in the same order as the
JAX package's, so the same arguments and seed give a byte-equal bundle (a
test holds them equal).
"""

from __future__ import annotations

from typing import List

import numpy as np
import scipy.sparse as sp

from sagnn_tpu_torch.data.graph import build_user_item_csr
from sagnn_tpu_torch.data.io import DatasetBundle


def _zipf_item_probs(num_items: int, alpha: float, rng: np.random.Generator):
    ranks = np.arange(1, num_items + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    rng.shuffle(p)
    return p / p.sum()


def synthetic_dataset(
    num_users: int = 64,
    num_items: int = 128,
    graph_num: int = 3,
    seq_len_range: tuple[int, int] = (6, 30),
    test_size: int = 20,
    alpha: float = 1.05,
    seed: int = 0,
    num_clusters: int = 8,
    cluster_strength: float = 0.8,
) -> DatasetBundle:
    """Generate a DatasetBundle with the reference's data invariants:

    - per-user time-ordered sequences (last item = test target,
      leave-one-out as in preprocess_to_trnmat.ipynb cells 3-4)
    - interval matrices cover TRAIN interactions split into `graph_num`
      equal time spans
    - `test_dict` holds `test_size - 1` negatives, 1-indexed (SURVEY.md Q8)

    Interactions follow a latent-cluster preference model (each user belongs
    to a cluster drawing `cluster_strength` of its items from the cluster's
    item block, zipf-popularity within block) so that ranking the held-out
    positive against popularity-sampled negatives is LEARNABLE — pure
    popularity sampling would make HR@K equal to chance.
    """
    rng = np.random.default_rng(seed)
    probs = _zipf_item_probs(num_items, alpha, rng)
    # cluster-conditional item distributions
    item_cluster = rng.integers(0, num_clusters, size=num_items)
    cluster_probs = []
    for c in range(num_clusters):
        inb = item_cluster == c
        p = probs * np.where(inb, cluster_strength / max(probs[inb].sum(),
                                                         1e-12),
                             (1 - cluster_strength)
                             / max(probs[~inb].sum(), 1e-12))
        cluster_probs.append(p / p.sum())

    sequences: List[List[int]] = []
    times: List[np.ndarray] = []
    user_cluster = rng.integers(0, num_clusters, size=num_users)
    log_ps = [np.log(np.maximum(p, 1e-30)) for p in cluster_probs]
    for u in range(num_users):
        n = int(rng.integers(seq_len_range[0], seq_len_range[1] + 1))
        n = min(n, num_items - 1)
        # Gumbel top-k: exact weighted sampling WITHOUT replacement in one
        # pass (np's choice(replace=False, p=...) rejection-samples and
        # livelocks when n approaches num_items under a skewed p)
        keys = log_ps[user_cluster[u]] + rng.gumbel(size=num_items)
        items = np.argpartition(-keys, n)[:n]
        rng.shuffle(items)
        t = np.sort(rng.integers(0, 10_000, size=n))
        sequences.append(items.tolist())
        times.append(t)

    tst_int = np.empty(num_users, dtype=object)
    test_dict = {}
    train_seqs: List[List[int]] = []
    rows, cols, vals = [], [], []
    t_min = min(int(t[0]) for t in times)
    t_max = max(int(t[-1]) for t in times)
    span = max(1, t_max - t_min + 1)

    for u, (items, t) in enumerate(zip(sequences, times)):
        tst_int[u] = items[-1]
        train_items, train_t = items[:-1], t[:-1]
        train_seqs.append(list(train_items))
        rows.extend([u] * len(train_items))
        cols.extend(train_items)
        vals.extend(train_t.tolist())
        # negatives exclude the user's full history (vectorized rejection)
        seen = np.zeros(num_items, dtype=bool)
        seen[items] = True
        need = test_size - 1
        negs: List[int] = []
        while len(negs) < need:
            cands = rng.choice(num_items, size=2 * need, p=probs)
            good = cands[~seen[cands]]
            negs.extend((good[: need - len(negs)] + 1).tolist())  # 1-indexed
        test_dict[u + 1] = negs

    full = sp.csr_matrix(
        (np.array(vals, dtype=np.int64) + 1,
         (np.array(rows), np.array(cols))),
        shape=(num_users, num_items))

    sub_mats = []
    rows_a = np.array(rows)
    cols_a = np.array(cols)
    vals_a = np.array(vals, dtype=np.int64)
    for k in range(graph_num):
        lo = t_min + k * span // graph_num
        hi = t_min + (k + 1) * span // graph_num
        m = (vals_a >= lo) & (vals_a < hi)
        sub = sp.csr_matrix(
            (vals_a[m] + 1, (rows_a[m], cols_a[m])),
            shape=(num_users, num_items))
        sub_mats.append(sub)

    # NOTE: sequences in the bundle are the TRAIN sequences; the reference's
    # `sequence` pickle holds training interactions only (test item held out,
    # preprocess_to_sequence.ipynb cells 3-7) and tstInt holds the target.
    trn_mat = build_user_item_csr(train_seqs, num_users, num_items)
    return DatasetBundle(
        num_users=num_users,
        num_items=num_items,
        trn_mat=trn_mat,
        sub_mats=sub_mats,
        time_mat=full.copy(),
        sequences=train_seqs,
        tst_int=tst_int,
        test_dict=test_dict,
    )


def synthetic_edges(
    num_edges: int,
    num_users: int,
    num_items: int,
    graph_num: int,
    alpha: float = 1.05,
    seed: int = 0,
    chunk: int = 4_000_000,
):
    """Stream (user, item, interval) COO chunks for huge benchmark graphs:
    int32 (rows, cols, ks) chunks of at most `chunk` edges, user and item
    popularity both zipf-like (alpha 0.7·alpha and alpha), intervals
    uniform."""
    rng = np.random.default_rng(seed)
    u_probs = _zipf_item_probs(num_users, alpha * 0.7, rng)
    i_probs = _zipf_item_probs(num_items, alpha, rng)
    remaining = num_edges
    while remaining > 0:
        n = min(chunk, remaining)
        rows = rng.choice(num_users, size=n, p=u_probs).astype(np.int32)
        cols = rng.choice(num_items, size=n, p=i_probs).astype(np.int32)
        ks = rng.integers(0, graph_num, size=n).astype(np.int32)
        yield rows, cols, ks
        remaining -= n


def synthetic_interval_mats(num_edges: int, num_users: int, num_items: int,
                            graph_num: int, seed: int = 0) -> list:
    """One binary [num_users, num_items] CSR per interval from
    `synthetic_edges` (duplicates summed, then set to 1)."""
    per_k_rows: list = [[] for _ in range(graph_num)]
    per_k_cols: list = [[] for _ in range(graph_num)]
    for rows, cols, ks in synthetic_edges(num_edges, num_users, num_items,
                                          graph_num, seed=seed):
        for k in range(graph_num):
            m = ks == k
            per_k_rows[k].append(rows[m])
            per_k_cols[k].append(cols[m])
    mats = []
    for k in range(graph_num):
        r = np.concatenate(per_k_rows[k])
        c = np.concatenate(per_k_cols[k])
        m = sp.csr_matrix((np.ones(len(r), dtype=np.int8), (r, c)),
                          shape=(num_users, num_items))
        m.data[:] = 1
        mats.append(m)
    return mats


def synthetic_large_dataset(
    num_users: int,
    num_items: int,
    total_edges: int,
    graph_num: int,
    test_size: int = 100,
    num_test_users: int = 4096,
    seed: int = 0,
    num_clusters: int = 64,
    in_cluster: float = 0.6,
) -> DatasetBundle:
    """Fully VECTORIZED DatasetBundle generator for huge scale (1M+ users,
    100M+ edges) — `synthetic_dataset`'s per-user Gumbel loop is O(U·I) and
    unusable there. Same invariants: time-ordered train sequences, last item
    held out (tst_int set for `num_test_users` sampled users), interval
    matrices over equal time spans, 1-indexed test_dict negatives.

    Item choice is power-law (cdf r^3) with an in-cluster preference
    (user cluster = uid % num_clusters) so ranking stays learnable; exact
    per-user dedup is skipped (duplicate interactions also occur in real
    logs and the CSR structure dedups itself).
    """
    rng = np.random.default_rng(seed)
    u = rng.integers(0, num_users, total_edges).astype(np.int64)
    # guarantee every user >= 4 interactions (train sampler needs len >= 2,
    # test protocol needs a held-out item + history)
    u = np.concatenate([u, np.repeat(np.arange(num_users, dtype=np.int64),
                                     4)])
    E = len(u)
    r = rng.random(E)
    base = (num_items * r ** 3.0).astype(np.int64)      # power-law-ish
    blk = max(1, num_items // num_clusters)
    uc = u % num_clusters
    inb = rng.random(E) < in_cluster
    items = np.where(inb, uc * blk + base % blk, base)
    items = np.minimum(items, num_items - 1)
    # scatter popularity across the id space (like real preprocessed
    # datasets, whose ids are first-appearance order): without this, hot
    # items concentrate at low ids and source-sharded SpMM plans get one
    # pathologically overloaded shard
    perm = rng.permutation(num_items).astype(np.int32)
    items = perm[items]
    t = rng.integers(0, 10_000, E).astype(np.int64)
    order = np.lexsort((t, u))
    u, items, t = u[order], items[order], t[order]
    bounds = np.searchsorted(u, np.arange(num_users + 1))

    # train split: drop each user's LAST edge (leave-one-out)
    keep = np.ones(E, dtype=bool)
    keep[bounds[1:] - 1] = False
    last = items[bounds[1:] - 1]
    sequences = [items[bounds[x]:bounds[x + 1] - 1]
                 for x in range(num_users)]

    tst_int = np.empty(num_users, dtype=object)
    tst_int[:] = None
    test_users = rng.choice(num_users,
                            size=min(num_test_users, num_users),
                            replace=False)
    test_dict = {}
    need = test_size - 1
    for tu in test_users:
        tu = int(tu)
        tst_int[tu] = int(last[tu])
        seen = set(items[bounds[tu]:bounds[tu + 1]].tolist())
        negs: List[int] = []
        while len(negs) < need:
            cands = rng.integers(0, num_items, 2 * need)
            negs.extend(int(c) + 1 for c in cands
                        if c not in seen)  # 1-indexed (Q8)
        test_dict[tu + 1] = negs[:need]

    tr_u, tr_i, tr_t = u[keep], items[keep], t[keep]
    trn_mat = sp.csr_matrix(
        (np.ones(len(tr_u), dtype=np.int8), (tr_u, tr_i)),
        shape=(num_users, num_items))
    trn_mat.data[:] = 1  # dedup summed duplicates to binary

    t_min, t_max = int(tr_t.min()), int(tr_t.max())
    span = max(1, t_max - t_min + 1)
    interval = np.minimum(((tr_t - t_min) * graph_num) // span,
                          graph_num - 1)
    sub_mats = []
    for k in range(graph_num):
        m = interval == k
        sub = sp.csr_matrix(
            (tr_t[m] + 1, (tr_u[m], tr_i[m])),
            shape=(num_users, num_items))
        sub_mats.append(sub)

    return DatasetBundle(
        num_users=num_users, num_items=num_items, trn_mat=trn_mat,
        sub_mats=sub_mats, time_mat=None, sequences=sequences,
        tst_int=tst_int, test_dict=test_dict,
    )
