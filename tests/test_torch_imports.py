"""The port and chip_smoke.py import neither JAX nor the JAX package."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "sagnn_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, ROOT) for p in out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            mods.append(node.args[0].value)
    return mods


def _forbidden(mod):
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "sagnn_tpu")


@pytest.mark.parametrize("rel", _port_files())
def test_no_jax_imports(rel):
    bad = [m for m in _imported_modules(os.path.join(ROOT, rel))
           if _forbidden(m)]
    assert not bad, f"{rel} imports {bad}"


def test_scan_sees_forbidden_names():
    assert _forbidden("jax.numpy") and _forbidden("sagnn_tpu.config")
    assert not _forbidden("sagnn_tpu_torch.config")
    assert "chip_smoke.py" in _port_files()
    assert len(_port_files()) > 15
