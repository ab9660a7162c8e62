"""Dataset loading and saving in the reference's pickle formats; the port's
copy of `sagnn_tpu/data/io.py` (ref: DataHandler.py:71-133).

On-disk layout per dataset directory (identical to the reference so its
preprocessed datasets drop in unchanged):
  trn_mat_time — pickle of [full_csr(U×I), [graph_num interval csr], time_csr]
  tst_int      — pickle list[U] of test item id or None
  sequence     — pickle list[U] of per-user time-ordered item lists
  test_dict    — pickle {1-indexed uid: [999 negative item ids, 1-indexed]}
  noise_%.2f   — optional perturbed trn_mat_time (--percent mode,
                 DataHandler.py:87-90)

The files are unpickled, so load only datasets this project or the
reference's preprocessing wrote.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp

from sagnn_tpu_torch.data.graph import build_user_item_csr


@dataclass
class DatasetBundle:
    """Everything the model needs, mirroring DataHandler's attributes."""

    num_users: int
    num_items: int
    trn_mat: sp.csr_matrix            # binary U×I, rebuilt from sequences
    sub_mats: List[sp.csr_matrix]     # graph_num interval matrices
    time_mat: Optional[sp.spmatrix]   # raw timestamp matrix (unused in parity path)
    sequences: List[List[int]]        # per-user ordered item lists
    tst_int: np.ndarray               # object array: test item or None per user
    test_dict: Dict[int, List[int]]   # 1-indexed uid -> 999 1-indexed negatives
    max_time: int = 1                 # timeProcess is disabled in the reference
                                      # (DataHandler.py:164-165), so maxTime=1

    @property
    def tst_usrs(self) -> np.ndarray:
        # DataHandler.py:104-106
        return np.reshape(np.argwhere(self.tst_int != None), [-1])  # noqa: E711

    @property
    def graph_num(self) -> int:
        return len(self.sub_mats)


def _load_pickle(path: str):
    with open(path, "rb") as fs:
        return pickle.load(fs)


def load_tst_int(path: str) -> np.ndarray:
    """The `tst_int` pickle as the reference consumes it
    (DataHandler.py:96-97): a length-U object array whose entries are the
    user's single held-out test item id (0-indexed, used directly —
    unlike `test_dict`, whose uids/items are 1-indexed, Q8) or None for
    users with no test interaction. Kept as dtype=object so the
    `tst_int != None` mask (tst_usrs) works elementwise."""
    return np.array(_load_pickle(path), dtype=object)


def load_dataset(predir: str, noise_percent: float = 0.0) -> DatasetBundle:
    """Load one dataset directory (ref: DataHandler.LoadData, 86-133)."""
    if noise_percent > 1e-8:
        trn = _load_pickle(os.path.join(predir, f"noise_{noise_percent:.2f}"))
    else:
        trn = _load_pickle(os.path.join(predir, "trn_mat_time"))
    full_mat, sub_mats, time_mat = trn[0], trn[1], trn[2]
    tst_int = load_tst_int(os.path.join(predir, "tst_int"))
    sequences = _load_pickle(os.path.join(predir, "sequence"))
    test_dict_path = os.path.join(predir, "test_dict")
    test_dict = (_load_pickle(test_dict_path)
                 if os.path.isfile(test_dict_path) else {})

    num_users, num_items = full_mat.shape
    # The reference rebuilds the training matrix from sequences rather than
    # using full_mat directly (DataHandler.py:126-127).
    trn_mat = build_user_item_csr(sequences, num_users, num_items)
    return DatasetBundle(
        num_users=num_users,
        num_items=num_items,
        trn_mat=trn_mat,
        sub_mats=[sp.csr_matrix(m) for m in sub_mats],
        time_mat=time_mat,
        sequences=sequences,
        tst_int=tst_int,
        test_dict=test_dict,
    )


def save_dataset(predir: str, bundle: DatasetBundle,
                 full_mat: Optional[sp.spmatrix] = None) -> None:
    """Write a DatasetBundle in the reference's pickle layout (the four
    files above; `full_mat` defaults to the bundle's trn_mat)."""
    os.makedirs(predir, exist_ok=True)
    if full_mat is None:
        full_mat = bundle.trn_mat
    with open(os.path.join(predir, "trn_mat_time"), "wb") as fs:
        pickle.dump([sp.csr_matrix(full_mat), list(bundle.sub_mats),
                     bundle.time_mat], fs)
    with open(os.path.join(predir, "tst_int"), "wb") as fs:
        pickle.dump(list(bundle.tst_int), fs)
    with open(os.path.join(predir, "sequence"), "wb") as fs:
        pickle.dump(bundle.sequences, fs)
    with open(os.path.join(predir, "test_dict"), "wb") as fs:
        pickle.dump(bundle.test_dict, fs)
