"""A cell, found by name: its `BENCHMARK.json` entry and the files that
entry names (`configs/<config>.json`, `traffic/<traffic>.json`, the
traffic's `logs/<log>.json`, `limits/<cell>.json`)."""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _load(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    log: dict               # logs/<traffic's log>.json
    limits: dict = field(default_factory=dict)   # limits/<name>.json
    chips: int = 1

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def model(self) -> dict:
        return self.config["model"]

    def program_config(self, seed: int, **model_overrides):
        """The program's `Config`: the preset with the file's model and
        train values as run, train.seed = the run's seed."""
        from sagnn_tpu_torch.config import Config

        cfg = Config.preset(self.config["preset"])
        model = {**self.config["model"], **model_overrides}
        train = {**self.config["train"], "seed": int(seed) % (2 ** 63)}
        return cfg.replace(
            model=dataclasses.replace(cfg.model, **model),
            train=dataclasses.replace(cfg.train, **train))


def load_cell(name: str, benchmark: Optional[dict] = None) -> Cell:
    """The workload `name` of BENCHMARK.json (or of `benchmark`)."""
    if benchmark is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            benchmark = json.load(f)
    entry = next((w for w in benchmark["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    traffic = _load("traffic", entry["traffic"] + ".json")
    limits_path = os.path.join(HERE, "limits", name + ".json")
    limits = _load("limits", name + ".json") \
        if os.path.isfile(limits_path) else {}
    return Cell(name=name, config=_load("configs", entry["config"] + ".json"),
                traffic=traffic, log=_load("logs", traffic["log"] + ".json"),
                limits=limits, chips=int(entry["chips"]))


def end_to_end_metrics(benchmark: dict, cell: str) -> list:
    """The end-to-end metric entries that `cell` reports."""
    return [m for m in benchmark["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_metrics(benchmark: dict, cell: str) -> list:
    """The per-layer metric entries listed for `cell` (an entry without a
    "workloads" key is read in every cell that reports its `moves`)."""
    mine = {m["name"] for m in end_to_end_metrics(benchmark, cell)}
    return [m for m in benchmark["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]
