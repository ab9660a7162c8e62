"""The reference against the program's plain CPU path at a tiny size: a
whole run of each kind of cell, with the limits the cells use, comes out
correct; the reference's optimizer by hand; and the reference imports
nothing of the program."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from conftest import ROOT, load_benchmark, tiny_cell


def run_tiny(name: str, seed: int = 3) -> dict:
    from benchmark import run
    return run.run_cell(tiny_cell(name), load_benchmark(), seed, 0.1, False,
                        torch.device("cpu"), 0.0)


@pytest.mark.parametrize("name", ["gowalla.train", "yelp.train",
                                  "gowalla.serve", "yelp.serve"])
def test_sound_run_is_correct(name, cpu_threads):
    out = run_tiny(name)
    assert out["correct"], out["check"]
    assert out["device"]["platform"] == "cpu"
    assert list(out)[-1] == "check"


def test_tf1_adam_by_hand():
    from benchmark.reference.selfgnn import TF1Adam

    p = {"w": torch.tensor([1.0, -2.0], dtype=torch.float64)}
    opt = TF1Adam(lr=0.1, decay=0.5, decay_steps=1)
    g = torch.tensor([0.5, -4.0], dtype=torch.float64)
    w = p["w"].clone()
    m = torch.zeros(2, dtype=torch.float64)
    v = torch.zeros(2, dtype=torch.float64)
    for t in (1, 2):
        opt.step(p, {"w": g})
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        # the step size in f32, as TF1's scalars are
        f = np.float32
        rate = f(0.1) * f(0.5) ** f(t - 1)
        size = float(rate * np.sqrt(f(1) - f(0.999) ** f(t))
                     / (f(1) - f(0.9) ** f(t)))
        w = w - size * m / (v.sqrt() + 1e-8)
    assert torch.allclose(p["w"], w, rtol=0, atol=1e-15)


def test_reference_imports_nothing_of_the_program():
    folder = os.path.join(ROOT, "benchmark", "reference")
    for name in os.listdir(folder):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(folder, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("sagnn_tpu_torch", "sagnn_tpu", "jax",
                                   "benchmark"), (name, mod)
