"""Host-side batch samplers; the port of `sagnn_tpu/data/sampler.py`
(ref: model.py:252-339, 384-428; DataHandler.py:28-41).

The sampling semantics are the reference's; the arrays are fixed-shape
and padded, with masks:

  * Train (ref sampleTrainBatch): per user, target = sequence[-choose]
    with choose ~ randint(1, max(min(pred_num+1, len(posset)-3), 1)),
    repeated sampNum = min(samp_num, len(posset)) times; negatives are
    rejection-sampled uniformly over items, excluding the user's train
    row, the last sequence item and the test item (negSamp,
    DataHandler.py:28-41). Users with an empty posset contribute no pairs.
  * SSL (ref sampleSslBatch): per interval and user, min(ssl_num,
    |row|//2) pairs of interacted items drawn WITH replacement; the
    reference interleaves the draws and pairs entry j with entry j+len/2
    in the loss (model.py:186-196), and that split (Q7) happens here so
    the device gets aligned (A, B) halves.
  * Test (ref sampleTestBatch): candidates = testSize-1 precomputed
    1-indexed negatives (minus 1) + the positive appended LAST.
  * Full sort (no reference analog): the positive against the whole
    catalog but the user's own train row. Eval sampling draws no random
    numbers.

Two backends draw the per-user numbers, as in the JAX package: "native"
(`native/sampler.cc` through `data/native_sampler.py`, xoshiro256** per
user) and "numpy" (`default_rng((seed, user))` per user). Both take the
epoch permutations and the per-batch seeds from one `default_rng(seed)`.
Each gives the JAX Sampler's arrays of the same backend byte for byte for
the same seed and call sequence. "auto" (the default) takes "native" and
falls back to "numpy" only where the library cannot be built or loaded.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from sagnn_tpu_torch.data import native_sampler as ns
from sagnn_tpu_torch.data.io import DatasetBundle
from sagnn_tpu_torch.models.selfgnn import TrainBatch
from sagnn_tpu_torch.utils.logger import log

BACKENDS = ("auto", "native", "numpy")


def _fill_sequence(row_items: Sequence[int], pos_length: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Right-aligned, zero-padded sequence + mask (model.py:286-294)."""
    seq = np.zeros(pos_length, dtype=np.int32)
    mask = np.zeros(pos_length, dtype=np.float32)
    n = len(row_items)
    if n == 0:
        return seq, mask
    if n <= pos_length:
        seq[-n:] = row_items
        mask[-n:] = 1.0
    else:
        seq[:] = row_items[-pos_length:]
        mask[:] = 1.0
    return seq, mask


def user_sequences(bundle: DatasetBundle, user_ids: np.ndarray,
                   pos_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """[B, L] sequences + masks of each user's whole train history, the
    serving input (scripts/recommend.py fills them the same way)."""
    seq = np.zeros((len(user_ids), pos_length), np.int32)
    mask = np.zeros((len(user_ids), pos_length), np.float32)
    for i, u in enumerate(user_ids):
        seq[i], mask[i] = _fill_sequence(bundle.sequences[u], pos_length)
    return seq, mask


def test_batch(bundle: DatasetBundle, bat_ids: np.ndarray, test_size: int,
               pos_length: int, test_mode: bool = True,
               batch_cap: int | None = None):
    """Returns (user_ids [B], cand_iids [B, C], pos_items [B],
    seq [B, L], seq_mask [B, L], valid [B]), the positive LAST in the
    candidate axis (model.py:403-404). Rows past len(bat_ids) are zero with
    valid 0. batch_cap sizes the arrays (default len(bat_ids))."""
    B = batch_cap or len(bat_ids)
    C = test_size
    user_ids = np.zeros(B, dtype=np.int32)
    cand = np.zeros((B, C), dtype=np.int32)
    pos_items = np.zeros(B, dtype=np.int32)
    seq = np.zeros((B, pos_length), dtype=np.int32)
    seq_mask = np.zeros((B, pos_length), dtype=np.float32)
    valid = np.zeros(B, dtype=np.float32)

    for i, u in enumerate(bat_ids):
        if test_mode:
            pos = bundle.tst_int[u]
            posset = bundle.sequences[u]
        else:
            pos = bundle.sequences[u][-1]
            posset = bundle.sequences[u][:-1]
        negs = np.array(bundle.test_dict[u + 1][:C - 1]) - 1  # 1-indexed (Q8)
        cand[i] = np.concatenate([negs, [pos]])
        user_ids[i] = u
        pos_items[i] = pos
        seq[i], seq_mask[i] = _fill_sequence(posset, pos_length)
        valid[i] = 1.0
    return user_ids, cand, pos_items, seq, seq_mask, valid


def neg_sample(rng: np.random.Generator, seen: np.ndarray, samp_size: int,
               num_items: int, excluded: Tuple) -> np.ndarray:
    """Uniform rejection sampling (DataHandler.py:28-41): reject items the
    user interacted with (seen[item] True) and items in `excluded`."""
    out = np.empty(samp_size, dtype=np.int32)
    cur = 0
    while cur < samp_size:
        n_draw = max(8, 2 * (samp_size - cur))
        cands = rng.integers(0, num_items, size=n_draw)
        ok = ~seen[cands]
        for ex in excluded:
            if ex is not None:
                ok &= cands != ex
        good = cands[ok]
        take = min(len(good), samp_size - cur)
        out[cur:cur + take] = good[:take]
        cur += take
    return out


class Sampler:
    """Stateful host sampler over one DatasetBundle (JAX `Sampler`).

    backend: "native" raises if the library cannot be built or loaded;
    "auto" then logs the failure and takes "numpy". `self.backend` is the
    one taken."""

    def __init__(self, bundle: DatasetBundle, batch: int, samp_num: int,
                 ssl_num: int, pred_num: int, pos_length: int,
                 test_size: int, seed: int = 100, backend: str = "auto"):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        self.bundle = bundle
        self.batch = batch
        self.samp_num = samp_num
        self.ssl_num = ssl_num
        self.pred_num = pred_num
        self.pos_length = pos_length
        self.test_size = test_size
        self.rng = np.random.default_rng(seed)
        self._trn_csr = bundle.trn_mat.tocsr()
        self._sub_csrs = [m.tocsr() for m in bundle.sub_mats]
        # one user's train row as a boolean item mask, set and cleared per
        # user: the JAX sampler's `label_row != 0` test without building a
        # dense [batch, num_items] block per batch
        self._seen = np.zeros(bundle.num_items, dtype=bool)
        self._deg_cache = None      # see _max_train_deg
        self._native = None
        if backend != "numpy":
            try:
                lib = ns.load_library()
            except (RuntimeError, OSError) as e:
                if backend == "native":
                    raise
                log(f"sampler: native library unavailable "
                    f"({str(e).splitlines()[0]}); numpy backend")
            else:
                self._native = (lib, ns.NativeSamplerState(
                    bundle.sequences, self._trn_csr, self._sub_csrs,
                    bundle.tst_int))
        self.backend = "numpy" if self._native is None else "native"
        log(f"sampler: {self.backend} backend")

    @property
    def _max_train_deg(self) -> int:
        """Exclusion-list width for full_sort_batch: the max train-row
        degree, rounded up to a multiple of 64 (at least 64), so the shapes
        are stable across runs of similar datasets."""
        if self._deg_cache is None:
            deg = np.diff(self._trn_csr.indptr)
            self._deg_cache = max(
                64, -(-int(deg.max(initial=1)) // 64) * 64)
        return self._deg_cache

    # -- train ------------------------------------------------------------

    def epoch_user_ids(self, trn_num: int) -> np.ndarray:
        """np.random.permutation(num_users)[:trnNum] (model.py:343)."""
        return self.rng.permutation(self.bundle.num_users)[:trn_num]

    def train_batch(self, bat_ids: np.ndarray,
                    batch_cap: Optional[int] = None,
                    ssl_ids: Optional[np.ndarray] = None,
                    ssl_cols: Optional[Tuple[int, int]] = None
                    ) -> TrainBatch:
        """One train batch (numpy arrays) for `bat_ids`, sized for
        `batch_cap` users (default `self.batch`); rows past len(bat_ids)
        are padding with mask 0. Per-user draws are seeded by (batch_seed,
        user) and land in fixed per-user slots, the JAX sampler's
        determinism contract: a slice of a batch draws exactly the rows the
        whole batch would. ssl_ids: the id set of the SSL half (default
        bat_ids), whose pairing is global across the batch; ssl_cols:
        (start, size), only that window of the SSL pair columns
        (`ssl_batch`)."""
        batch_seed = int(self.rng.integers(0, 2 ** 63))
        ssl = self.ssl_batch(bat_ids if ssl_ids is None else ssl_ids,
                             ssl_cols=ssl_cols)
        B = batch_cap or self.batch
        if self._native is not None:
            lib, state = self._native
            uids, pos_iids, neg_iids, useq_row, pair_mask, seq, mask = \
                ns.native_train_batch(lib, state, bat_ids, B,
                                      self.samp_num, self.pred_num,
                                      self.pos_length, self.bundle.num_items,
                                      batch_seed)
            return TrainBatch(uids=uids, pos_iids=pos_iids,
                              neg_iids=neg_iids, useq_row=useq_row,
                              pair_mask=pair_mask, seq=seq, seq_mask=mask,
                              **ssl)
        b = self.bundle
        P = B * self.samp_num
        uids = np.zeros(P, dtype=np.int32)
        pos_iids = np.zeros(P, dtype=np.int32)
        neg_iids = np.zeros(P, dtype=np.int32)
        useq_row = np.zeros(P, dtype=np.int32)
        pair_mask = np.zeros(P, dtype=np.float32)
        seq = np.zeros((B, self.pos_length), dtype=np.int32)
        seq_mask = np.zeros((B, self.pos_length), dtype=np.float32)

        csr = self._trn_csr
        for i, u in enumerate(bat_ids):
            rng_u = np.random.default_rng((batch_seed, int(u)))
            full_seq = b.sequences[u]
            posset = full_seq[:-1]
            samp = min(self.samp_num, len(posset))
            choose = 1
            if samp > 0:
                cur = i * self.samp_num
                hi = max(min(self.pred_num + 1, len(posset) - 3), 1)
                choose = int(rng_u.integers(1, hi + 1))  # randint incl.
                pos = posset[-choose]
                lo_, hi_ = csr.indptr[u], csr.indptr[u + 1]
                row = csr.indices[lo_:hi_][csr.data[lo_:hi_] != 0]
                self._seen[row] = True
                try:
                    negs = neg_sample(rng_u, self._seen, samp, b.num_items,
                                      (full_seq[-1], b.tst_int[u]))
                finally:
                    self._seen[row] = False
                uids[cur:cur + samp] = u
                useq_row[cur:cur + samp] = i
                pos_iids[cur:cur + samp] = pos
                neg_iids[cur:cur + samp] = negs
                pair_mask[cur:cur + samp] = 1.0
            seq[i], seq_mask[i] = _fill_sequence(posset[:-choose] if choose
                                                 else posset, self.pos_length)
        return TrainBatch(uids=uids, pos_iids=pos_iids, neg_iids=neg_iids,
                          useq_row=useq_row, pair_mask=pair_mask, seq=seq,
                          seq_mask=seq_mask, **ssl)

    def train_batch_slice(self, bat_ids: np.ndarray, start: int,
                          size: int) -> TrainBatch:
        """Rows [start, start + size) of the batch `bat_ids` (JAX
        `Sampler.train_batch_slice`, sampler.py:165-180): the train arrays
        of those users and the SSL pair columns [start·ssl_num,
        (start + size)·ssl_num), equal byte for byte to the same rows and
        columns of `train_batch(bat_ids)` by the determinism contracts of
        `train_batch` and `ssl_batch`, and drawing the same numbers from
        self.rng. useq_row stays local to the slice's seq rows."""
        return self.train_batch(
            bat_ids[start:start + size], batch_cap=size, ssl_ids=bat_ids,
            ssl_cols=(start * self.ssl_num, size * self.ssl_num))

    # -- ssl ---------------------------------------------------------------

    def ssl_batch(self, bat_ids: np.ndarray,
                  ssl_cols: Optional[Tuple[int, int]] = None) -> dict:
        """SSL pair arrays [g, batch * ssl_num], or the [g, size] column
        window ssl_cols = (start, size) of them.

        Reference layout (model.py:186-196 + 328-338): interleaved
        (u, pos_j)(u, neg_j) draws flattened across the batch, split at the
        global half, so pair column j pairs flat entry j with entry
        half + j. One seed per interval from self.rng, drawn whatever the
        window; per-user draws seeded by (interval_seed, user) land at flat
        positions fixed by the per-user pair counts (min(ssl_num,
        |row|//2), prefix-summed over the batch), so any window equals
        those columns of the whole batch's arrays (JAX's contract,
        sampler.py:234-258)."""
        g = self.bundle.graph_num
        col_start, col_size = ssl_cols or (0, self.batch * self.ssl_num)
        seeds = [int(self.rng.integers(0, 2 ** 63)) for _ in range(g)]
        out = {k: np.zeros((g, col_size),
                           np.float32 if k == "ssl_mask" else np.int32)
               for k in ("ssl_u_a", "ssl_i_a", "ssl_u_b", "ssl_i_b",
                         "ssl_mask")}
        for k in range(g):
            if self._native is None:
                self._ssl_interval(k, bat_ids, seeds[k], col_start,
                                   col_size, out)
                continue
            lib, state = self._native
            for key, a in zip(("ssl_u_a", "ssl_i_a", "ssl_u_b", "ssl_i_b",
                               "ssl_mask"),
                              ns.native_ssl_batch(lib, state, k, bat_ids,
                                                  self.ssl_num, seeds[k],
                                                  col_start, col_size)):
                out[key][k] = a
        return out

    def _ssl_interval(self, k: int, bat_ids: np.ndarray, seed: int,
                      col_start: int, col_size: int, out: dict) -> None:
        """Interval k's pairs in columns [col_start, col_start + col_size)
        into row k of `out` (JAX `_ssl_interval_numpy`): only the users
        whose draws reach the window draw."""
        csr = self._sub_csrs[k]
        ids = np.asarray(bat_ids, dtype=np.int64)
        deg = csr.indptr[ids + 1] - csr.indptr[ids]
        counts = 2 * np.minimum(self.ssl_num, deg // 2).astype(np.int64)
        prefix = np.zeros(len(ids) + 1, np.int64)
        np.cumsum(counts, out=prefix[1:])
        total = int(prefix[-1])
        half = total // 2
        col_end = col_start + col_size

        def emit(lo, hi, base, du, di):
            """Flat entries [lo, hi) into du/di from index lo - base."""
            if hi <= lo:
                return
            i = max(0, int(np.searchsorted(prefix, lo, "right")) - 1)
            while i < len(ids) and prefix[i] < hi:
                p0, c = int(prefix[i]), int(counts[i])
                u = int(ids[i])
                i += 1
                s, e = max(lo, p0), min(hi, p0 + c)
                if c == 0 or s >= e:
                    continue
                rng_u = np.random.default_rng((seed, u))
                row = csr.indices[csr.indptr[u]:csr.indptr[u + 1]]
                n = c // 2
                draws = rng_u.choice(row, c)      # with replacement
                inter = np.empty(c, np.int32)
                inter[0::2] = draws[:n]
                inter[1::2] = draws[n:]
                du[s - base:e - base] = u
                di[s - base:e - base] = inter[s - p0:e - p0]

        emit(col_start, min(col_end, half), col_start,
             out["ssl_u_a"][k], out["ssl_i_a"][k])
        emit(half + col_start, min(half + col_end, total),
             half + col_start, out["ssl_u_b"][k], out["ssl_i_b"][k])
        out["ssl_mask"][k, :max(0, min(col_end, half) - col_start)] = 1.0

    # -- test ---------------------------------------------------------------

    def test_batch(self, bat_ids: np.ndarray, test_mode: bool = True,
                   batch_cap: Optional[int] = None):
        """`test_batch` for this sampler's sizes (batch_cap defaults to
        self.batch)."""
        return test_batch(self.bundle, bat_ids, self.test_size,
                          self.pos_length, test_mode,
                          batch_cap or self.batch)

    def full_sort_batch(self, bat_ids: np.ndarray, test_mode: bool = True,
                        batch_cap: Optional[int] = None):
        """Full-catalog evaluation batch (JAX `Sampler.full_sort_batch`,
        sampler.py:361-401): the positive is ranked against every item but
        the user's own train row.

        Returns (user_ids [B], pos_items [B], seq [B, L], seq_mask [B, L],
        excl_idx [B, K] int32, valid [B]). `excl_idx` lists the user's
        train-row item ids minus the positive, padded with num_items (an id
        past the catalog, which the evaluation masks), K =
        `_max_train_deg`. batch_cap sizes the arrays (default
        self.batch)."""
        b = self.bundle
        B = batch_cap or self.batch
        K = self._max_train_deg
        user_ids = np.zeros(B, dtype=np.int32)
        pos_items = np.zeros(B, dtype=np.int32)
        seq = np.zeros((B, self.pos_length), dtype=np.int32)
        seq_mask = np.zeros((B, self.pos_length), dtype=np.float32)
        excl_idx = np.full((B, K), b.num_items, dtype=np.int32)
        valid = np.zeros(B, dtype=np.float32)
        csr = self._trn_csr
        for i, u in enumerate(bat_ids):
            if test_mode:
                pos = b.tst_int[u]
                posset = b.sequences[u]
            else:
                pos = b.sequences[u][-1]
                posset = b.sequences[u][:-1]
            row = csr.indices[csr.indptr[u]:csr.indptr[u + 1]]
            row = row[row != pos]  # the positive is never excluded
            excl_idx[i, :len(row)] = row
            user_ids[i] = u
            pos_items[i] = pos
            seq[i], seq_mask[i] = _fill_sequence(posset, self.pos_length)
            valid[i] = 1.0
        return user_ids, pos_items, seq, seq_mask, excl_idx, valid
