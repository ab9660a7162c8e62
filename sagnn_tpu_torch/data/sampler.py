"""Evaluation batches; the eval side of `sagnn_tpu/data/sampler.py`
(ref: model.py:286-294, 384-428).

Test batches (ref sampleTestBatch): candidates = testSize-1 precomputed
1-indexed negatives (minus 1) + the positive appended LAST. Eval sampling
draws no random numbers, so the arrays equal the JAX Sampler's for the
same bundle. The training side (BPR and SSL batches) is not ported yet.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sagnn_tpu_torch.data.io import DatasetBundle


def _fill_sequence(row_items: List[int], pos_length: int
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
