"""Offline preprocessing from a raw interaction log to the dataset pickles;
the port of `sagnn_tpu/data/preprocess.py` (which replaces the reference's
preprocess_to_trnmat.ipynb and preprocess_to_sequence.ipynb).

Pipeline from a raw interaction stream (user, item, timestamp) to the
on-disk layout that `data.io.load_dataset` reads:

  1. id mapping with an optional min-timestamp filter  (nb trnmat cells 0-1)
  2. iterative k-core filtering                        (cell 2)
  3. leave-one-out split: each user's latest item is the test item
                                                       (cells 3-4)
  4. negative sampling: `n_negatives` per test user    (cell 3, seed 100)
  5. the split into `graph_num` interval CSR matrices holding timestamps,
     and the full train matrix                         (cells 7, 13-14)
  6. per-user time-ordered train sequences             (sequence nb 3-7)
  7. the 1-indexed test_dict of negatives              (sequence nb 8-13)

numpy and scipy only. Every output equals the JAX package's exactly: the
same `np.random.Generator` draws in the same order. The per-event and
per-draw Python loops of the JAX module are done with array operations
here (a log of millions of events takes seconds); each gives the same
values in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from sagnn_tpu_torch.data.graph import build_user_item_csr
from sagnn_tpu_torch.data.io import DatasetBundle


@dataclass
class RawInteractions:
    """Columnar raw event log."""

    users: np.ndarray    # arbitrary user keys (any dtype)
    items: np.ndarray    # arbitrary item keys
    times: np.ndarray    # int64 unix timestamps

    @staticmethod
    def from_csv(path: str, user_col=0, item_col=1, time_col=2,
                 delimiter=",", skip_header=1) -> "RawInteractions":
        """Read a delimited log with `np.genfromtxt(dtype=None)`, which
        infers each column's type, as the JAX package does: an all-numeric
        file comes back as one 2-D array, any other as a record array."""
        raw = np.genfromtxt(path, delimiter=delimiter,
                            skip_header=skip_header, dtype=None,
                            encoding="utf-8")
        fields = [raw[:, c] for c in range(raw.shape[1])] \
            if raw.dtype.names is None else [raw[n] for n in raw.dtype.names]
        return RawInteractions(
            users=np.asarray(fields[user_col]),
            items=np.asarray(fields[item_col]),
            times=np.asarray(fields[time_col], dtype=np.int64))


def map_ids(raw: RawInteractions, min_time: Optional[int] = None
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict, Dict]:
    """Dense 0-based ids (+ optional year/time filter, nb cells 0-1)."""
    keep = np.ones(len(raw.users), dtype=bool)
    if min_time is not None:
        keep &= raw.times >= min_time
    users, items, times = raw.users[keep], raw.items[keep], raw.times[keep]
    u_keys, u_ids = np.unique(users, return_inverse=True)
    i_keys, i_ids = np.unique(items, return_inverse=True)
    u_map = {k: idx for idx, k in enumerate(u_keys)}
    i_map = {k: idx for idx, k in enumerate(i_keys)}
    return u_ids.astype(np.int64), i_ids.astype(np.int64), times, u_map, i_map


def k_core_filter(u: np.ndarray, i: np.ndarray, t: np.ndarray,
                  user_core: int, item_core: int, max_iters: int = 50
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Iteratively drop users/items below their core threshold (nb cell 2:
    the reference applies 20/15/5-core per dataset) and re-densify ids."""
    for _ in range(max_iters):
        u_cnt = np.bincount(u)
        i_cnt = np.bincount(i)
        keep = (u_cnt[u] >= user_core) & (i_cnt[i] >= item_core)
        if keep.all():
            break
        u, i, t = u[keep], i[keep], t[keep]
        if len(u) == 0:
            break
    _, u = np.unique(u, return_inverse=True)
    _, i = np.unique(i, return_inverse=True)
    return u.astype(np.int64), i.astype(np.int64), t


def leave_one_out(u: np.ndarray, i: np.ndarray, t: np.ndarray,
                  num_users: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per user: index of the LATEST interaction = the test event
    (nb cells 3-4/8-9). Ties broken by position (stable). Returns
    (test_event_idx [U] int64, is_train mask [E])."""
    order = np.lexsort((np.arange(len(t)), t, u))  # by user, time, position
    u_sorted = u[order]
    # last event per user in the sorted stream
    last_pos = np.full(num_users, -1, dtype=np.int64)
    last_pos[u_sorted] = order  # later entries overwrite -> latest event
    is_train = np.ones(len(u), dtype=bool)
    valid = last_pos >= 0
    is_train[last_pos[valid]] = False
    return last_pos, is_train


def _draw_negatives(rng: np.random.Generator, is_seen: np.ndarray,
                    n: int) -> np.ndarray:
    """`sample_negatives` over a boolean mask of the seen items [I]."""
    parts, have = [np.zeros(0, np.int64)], 0
    while have < n:
        c = rng.integers(0, len(is_seen), n - have)
        parts.append(c[~is_seen[c]])
        have += len(parts[-1])
    return np.concatenate(parts)


def sample_negatives(rng: np.random.Generator, num_items: int,
                     interacted: Iterable[int], n: int) -> List[int]:
    """`n` item ids drawn uniformly from [0, num_items), each redrawn
    while it is in `interacted` (repeats allowed). JAX draws one id per
    call; here each call draws as many ids as are still missing, which
    takes the same values from the generator (its 32-bit draws are the
    same one at a time or in an array) and never one more, so the
    generator ends in the same state."""
    is_seen = np.zeros(num_items, dtype=bool)
    is_seen[np.fromiter(interacted, dtype=np.int64)] = True
    return _draw_negatives(rng, is_seen, n).tolist()


def preprocess(u: np.ndarray, i: np.ndarray, t: np.ndarray,
               graph_num: int, n_negatives: int = 999,
               user_core: int = 0, item_core: int = 0,
               seed: int = 100) -> DatasetBundle:
    """Full pipeline from dense-id events to a DatasetBundle.

    Matches the reference conventions: interval matrices hold raw timestamp
    values (trnmat nb cell 7), test_dict is 1-indexed (Q8), sequences hold
    train interactions time-ordered, tst_int the held-out item.
    """
    if user_core or item_core:
        u, i, t = k_core_filter(u, i, t, user_core, item_core)
    num_users = int(u.max()) + 1
    num_items = int(i.max()) + 1
    last_pos, is_train = leave_one_out(u, i, t, num_users)

    rng = np.random.default_rng(seed)
    tst_int = np.empty(num_users, dtype=object)
    tst_int[:] = None
    # each user's items (train and test), as runs of ids
    order = np.argsort(u, kind="stable")
    starts = np.searchsorted(u[order], np.arange(num_users + 1))
    items_of = i[order]
    is_seen = np.zeros(num_items, dtype=bool)
    test_dict: Dict[int, List[int]] = {}
    for uu in range(num_users):
        if last_pos[uu] >= 0:
            tst_int[uu] = int(i[last_pos[uu]])
            mine = items_of[starts[uu]:starts[uu + 1]]
            is_seen[mine] = True
            negs = _draw_negatives(rng, is_seen, n_negatives)
            is_seen[mine] = False
            test_dict[uu + 1] = (negs + 1).tolist()

    tu, ti, tt = u[is_train], i[is_train], t[is_train]
    # train sequences, time-ordered (stable on position for ties)
    order = np.lexsort((np.arange(len(tt)), tt, tu))
    bounds = np.cumsum(np.bincount(tu, minlength=num_users))[:-1]
    sequences: List[List[int]] = [s.tolist()
                                  for s in np.split(ti[order], bounds)]

    # full train matrix with timestamp values + interval split
    full = sp.csr_matrix((tt.astype(np.int64) + 1, (tu, ti)),
                         shape=(num_users, num_items))
    t_min, t_max = int(tt.min()), int(tt.max())
    span = max(1, t_max - t_min + 1)
    sub_mats = []
    for k in range(graph_num):
        lo = t_min + k * span // graph_num
        hi = t_min + (k + 1) * span // graph_num
        m = (tt >= lo) & (tt < hi) if k < graph_num - 1 else \
            (tt >= lo) & (tt <= t_max)
        sub_mats.append(sp.csr_matrix(
            (tt[m].astype(np.int64) + 1, (tu[m], ti[m])),
            shape=(num_users, num_items)))

    return DatasetBundle(
        num_users=num_users, num_items=num_items,
        trn_mat=build_user_item_csr(sequences, num_users, num_items),
        sub_mats=sub_mats, time_mat=full.copy(), sequences=sequences,
        tst_int=tst_int, test_dict=test_dict)


def add_noise(bundle: DatasetBundle, percent: float, seed: int = 0
              ) -> List:
    """Noise-robustness mode: produce a perturbed trn_mat_time payload with
    `percent` of random fake edges added per interval (the reference consumes
    precomputed noise_%.2f pickles, DataHandler.py:87-90)."""
    rng = np.random.default_rng(seed)
    noised = []
    for m in bundle.sub_mats:
        coo = sp.coo_matrix(m)
        n_add = int(coo.nnz * percent)
        rows = rng.integers(0, m.shape[0], n_add)
        cols = rng.integers(0, m.shape[1], n_add)
        vals = np.ones(n_add, dtype=coo.data.dtype)
        out = sp.csr_matrix(
            (np.concatenate([coo.data, vals]),
             (np.concatenate([coo.row, rows]),
              np.concatenate([coo.col, cols]))), shape=m.shape)
        noised.append(out)
    full = bundle.trn_mat
    return [full, noised, bundle.time_mat]
