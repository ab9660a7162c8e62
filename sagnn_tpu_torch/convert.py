"""Parameter layout shared with the JAX package; the port's side of the
layout that `sagnn_tpu/train/import_tf1.py` maps TF1 variables onto.

The JAX model keeps its parameters as a nested pytree
{"reg": {...}, "free": {..., "seq_mhsa": [ {...}, ... ]}}. The port keeps
one flat dict whose keys are that tree's paths joined by "/"
("reg/u_embed", "free/seq_mhsa/0/wq"). `params_from_numpy` flattens a tree
of numpy arrays (for example a JAX pytree after `np.asarray` on every
leaf) into the port's dict; `save_npz`/`load_npz` store the flat layout;
`opt_state_from_numpy` carries Adam's moments over in the same layout
(the layout of the optimizer state in `sagnn_tpu/train/trainer.py:332-394`).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts/lists/tuples -> {"a/b/0/c": leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def params_from_numpy(tree: Any, device: torch.device | str = "cpu"
                      ) -> Dict[str, torch.Tensor]:
    """A param tree with array leaves -> the port's flat f32 tensor dict."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in flatten_tree(tree).items()}


def save_npz(path: str, params: Dict[str, torch.Tensor]) -> None:
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in params.items()})


def load_npz(path: str, device: torch.device | str = "cpu"
             ) -> Dict[str, torch.Tensor]:
    with np.load(path, allow_pickle=False) as z:
        return {k: torch.from_numpy(z[k].astype(np.float32)).to(device)
                for k in z.files}


def opt_state_from_numpy(mu: Any, nu: Any, count: int,
                         device: torch.device | str = "cpu"):
    """A JAX `ScaleByAdamState`'s moments (param trees of arrays, e.g. after
    `np.asarray` on every leaf) and count -> the port's `AdamState` in the
    flat layout, so both optimizers can continue from the same moments."""
    from sagnn_tpu_torch.train.optim import AdamState
    return AdamState(mu=params_from_numpy(mu, device),
                     nu=params_from_numpy(nu, device), count=int(count))
