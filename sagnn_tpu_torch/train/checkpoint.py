"""Checkpoint and resume; the port of `sagnn_tpu/train/checkpoint.py` (ref:
model.py:512-527 saveHistory/loadModel).

Layout under `<root>/<save_path>/`, as in the JAX package:
  state         — `torch.save` of {params, Adam mu/nu/count, step}; the
                  JAX package writes an orbax directory of the same name
  history.json  — the MetricsHistory lists
  config.json   — the Config, so inference tooling can rebuild the model
  rng.json      — host RNG state for a trajectory-exact resume

Every file is written to `<name>.tmp` and renamed over the old one, so a
crash mid-save leaves the previous checkpoint readable. The write is
synchronous: `save` returns once every file is committed, whatever
`block` says, and `finalize` has nothing left to commit (the JAX package
overlaps its orbax write with training and commits later).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import torch

from sagnn_tpu_torch.train.metrics import MetricsHistory
from sagnn_tpu_torch.train.optim import AdamState


def _write_json(path: str, obj, **kw) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, **kw)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, root: str, save_path: str):
        self.dir = os.path.abspath(os.path.join(root, save_path))
        os.makedirs(self.dir, exist_ok=True)

    @property
    def _state_path(self) -> str:
        return os.path.join(self.dir, "state")

    @property
    def _history_path(self) -> str:
        return os.path.join(self.dir, "history.json")

    @property
    def _config_path(self) -> str:
        return os.path.join(self.dir, "config.json")

    @property
    def _rng_path(self) -> str:
        return os.path.join(self.dir, "rng.json")

    def save(self, state: Dict, history: MetricsHistory, config=None,
             block: bool = True, rng_state: Optional[Dict] = None) -> None:
        """state: the Trainer's {"params", "opt_state", "step"}. config: an
        optional `sagnn_tpu_torch.config.Config` stored beside the weights.
        rng_state: an optional JSON-able host-RNG snapshot
        (Trainer.capture_rng_state), so a resume from here replays the
        uninterrupted run. `block` is kept for the JAX package's API; the
        write is synchronous either way (module docstring)."""
        del block
        opt: AdamState = state["opt_state"]

        def host(d):
            return {k: v.detach().cpu() for k, v in d.items()}

        blob = {"params": host(state["params"]), "mu": host(opt.mu),
                "nu": host(opt.nu), "count": int(opt.count),
                "step": int(state["step"])}
        tmp = self._state_path + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, self._state_path)
        _write_json(self._history_path,
                    {k: list(v) for k, v in history.data.items()})
        if config is not None:
            _write_json(self._config_path, dataclasses.asdict(config),
                        indent=1)
        if rng_state is not None:
            _write_json(self._rng_path, rng_state)

    def finalize(self) -> None:
        """Nothing to commit: `save` writes synchronously."""

    def load_rng(self) -> Optional[Dict]:
        """The host-RNG sidecar of the last save, or None."""
        if not os.path.exists(self._rng_path):
            return None
        with open(self._rng_path) as f:
            return json.load(f)

    def load_config(self):
        """Rebuild the Config saved beside the checkpoint (or None)."""
        if not os.path.exists(self._config_path):
            return None
        from sagnn_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                            TrainConfig)
        with open(self._config_path) as f:
            d = json.load(f)
        return Config(model=ModelConfig(**d["model"]),
                      train=TrainConfig(**d["train"]),
                      data=DataConfig(**d["data"]))

    def load_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The saved params alone, on the CPU (None when nothing was
        saved): what serving needs of a checkpoint."""
        if not os.path.exists(self._state_path):
            return None
        return torch.load(self._state_path, map_location="cpu",
                          weights_only=True)["params"]

    def restore(self, template: Dict
                ) -> Tuple[Optional[Dict], MetricsHistory]:
        """The saved state, on the device of `template` (a state of the
        same model), with its params' requires_grad; (None, empty history)
        when nothing was saved. Raises if the saved shapes differ."""
        if not os.path.exists(self._state_path):
            return None, MetricsHistory()
        params_t = template["params"]
        device = next(iter(params_t.values())).device
        blob = torch.load(self._state_path, map_location=device,
                          weights_only=True)
        for part in ("params", "mu", "nu"):
            got = {k: tuple(v.shape) for k, v in blob[part].items()}
            want = {k: tuple(v.shape) for k, v in params_t.items()}
            if got != want:
                diff = sorted(set(got.items()) ^ set(want.items()))
                raise ValueError(f"checkpoint {part} do not fit the model: "
                                 f"{diff[:6]}")
        params = {k: blob["params"][k].requires_grad_(v.requires_grad)
                  for k, v in params_t.items()}
        state = {"params": params,
                 "opt_state": AdamState(mu=blob["mu"], nu=blob["nu"],
                                        count=int(blob["count"])),
                 "step": int(blob["step"])}
        hist = MetricsHistory()
        if os.path.exists(self._history_path):
            with open(self._history_path) as f:
                hist.data.update(json.load(f))
        return state, hist

    def resume_epoch(self, history: MetricsHistory, tst_epoch: int) -> int:
        """ref model.py:46: stloc = len(TrainLoss)*tstEpoch - (tstEpoch-1)."""
        n = len(history.data["TrainLoss"])
        return max(0, n * tst_epoch - (tst_epoch - 1))
