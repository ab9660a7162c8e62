"""Preprocessing CLI; the port of `scripts/preprocess.py` (which replaces
the reference's preprocess_to_trnmat.ipynb / preprocess_to_sequence.ipynb).

    python -m sagnn_tpu_torch.preprocess --csv raw.csv --out Datasets/mydata \\
        --graph_num 3 [--user_core 20 --item_core 20] [--min_time T] \\
        [--noise 0.1]

CSV columns: user,item,timestamp (header skipped). Writes the four pickles
(`trn_mat_time`, `tst_int`, `sequence`, `test_dict`) that
`python -m sagnn_tpu_torch.main --data mydata --data_dir Datasets` trains
on, plus the optional noise_%.2f payload (`--percent`). Host only: numpy
and scipy, no device.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import Optional, Sequence

from sagnn_tpu_torch.data.io import save_dataset
from sagnn_tpu_torch.data.preprocess import (RawInteractions, add_noise,
                                             map_ids, preprocess)
from sagnn_tpu_torch.utils.logger import log


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csv", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--graph_num", type=int, default=3)
    ap.add_argument("--n_negatives", type=int, default=999)
    ap.add_argument("--user_core", type=int, default=0)
    ap.add_argument("--item_core", type=int, default=0)
    ap.add_argument("--min_time", type=int, default=None)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=100)
    a = ap.parse_args(argv)

    t0 = time.perf_counter()
    log(f"reading {a.csv}")
    raw = RawInteractions.from_csv(a.csv)
    u, i, t, _umap, _imap = map_ids(raw, min_time=a.min_time)
    log(f"{len(u)} events, {u.max()+1} users, {i.max()+1} items "
        f"({time.perf_counter() - t0:.1f} s)")
    bundle = preprocess(u, i, t, graph_num=a.graph_num,
                        n_negatives=a.n_negatives, user_core=a.user_core,
                        item_core=a.item_core, seed=a.seed)
    log(f"after filtering: {bundle.num_users} users, {bundle.num_items} "
        f"items, {sum(m.nnz for m in bundle.sub_mats)} interval edges")
    save_dataset(a.out, bundle, full_mat=bundle.time_mat)
    log(f"wrote {a.out} ({time.perf_counter() - t0:.1f} s)")
    if a.noise > 0:
        payload = add_noise(bundle, a.noise, seed=a.seed)
        with open(os.path.join(a.out, f"noise_{a.noise:.2f}"), "wb") as f:
            pickle.dump(payload, f)
        log(f"wrote noise_{a.noise:.2f}")


if __name__ == "__main__":
    main()
