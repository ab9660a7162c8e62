"""Multi-process runs of the port on the CPU: `Sampler.train_batch_slice`
(byte for byte the rows of `train_batch`, on both backends, and JAX's
slices), `host_batch_slice`, and `python -m
sagnn_tpu_torch.parallel.multihost` over gloo: the ring across 2 and 4
processes against its checksum, and a 2-process training epoch against
the single-process 2 x 1 mesh (rtol 1e-4, as tests/test_multihost.py),
with the LSTM dropout on, from the port's draws and from JAX's (`--draws
jax`).

Each launcher runs in its own session with `--timeout 100` (it stops its
workers when one fails or the time is out); the test stops the whole
session if the launcher itself outlives 120 s. The workers are small:
tests/test_multihost.py's 48 x 64 bundle, a 60,000-edge ring.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from sagnn_tpu.data.sampler import Sampler as JSampler
from sagnn_tpu.data.synthetic import synthetic_dataset as j_synthetic
from sagnn_tpu_torch.data.sampler import Sampler
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.models.selfgnn import TrainBatch
from sagnn_tpu_torch.parallel import launch
from sagnn_tpu_torch.parallel.mesh import make_mesh
from sagnn_tpu_torch.parallel.multihost import (load_bundle, parse_args,
                                                train_config)
from sagnn_tpu_torch.train.trainer import Trainer

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = [f.name for f in dataclasses.fields(TrainBatch)]


def samplers(backend):
    kw = dict(batch=16, samp_num=4, ssl_num=3, pred_num=5, pos_length=16,
              test_size=10, seed=3)
    port = Sampler(synthetic_dataset(num_users=48, num_items=64,
                                     graph_num=2, test_size=10, seed=2),
                   backend=backend, **kw)
    jax_ = JSampler(bundle=j_synthetic(num_users=48, num_items=64,
                                       graph_num=2, test_size=10, seed=2),
                    backend=backend, **kw)
    return port, jax_


def assert_batch_equal(got, want, rows=None, cols=None, samp=4, ssl=3):
    """got equals rows [start, start + size) of want (pairs and sequences)
    and its SSL columns, byte for byte; useq_row local to the slice."""
    start, size = rows
    for name in FIELDS:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        if name.startswith("ssl_"):
            w = w[:, start * ssl:(start + size) * ssl]
        elif name in ("seq", "seq_mask"):
            w = w[start:start + size]
        else:
            w = w[start * samp:(start + size) * samp]
            if name == "useq_row":
                real = np.asarray(want.pair_mask)[
                    start * samp:(start + size) * samp] > 0
                w = np.where(real, w - start, 0)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_train_batch_slice_is_train_batch_rows(backend):
    """Each of 4 slices of a batch (13 users of 16: the last slice is
    padding) draws the same numbers as the whole batch: its rows and SSL
    columns byte for byte, and the RNG ends where the whole batch's
    does."""
    port, _ = samplers(backend)
    ids = port.epoch_user_ids(40)[:13]
    state = port.rng.bit_generator.state
    whole = port.train_batch(ids)
    after = port.rng.bit_generator.state
    for start in range(0, 16, 4):
        port.rng.bit_generator.state = state
        part = port.train_batch_slice(ids, start, 4)
        assert port.rng.bit_generator.state == after
        assert_batch_equal(part, whole, rows=(start, 4))


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_train_batch_slice_matches_jax(backend):
    port, jax_ = samplers(backend)
    ids = port.epoch_user_ids(40)[:16]
    assert np.array_equal(ids, jax_.epoch_user_ids(40)[:16])
    for start, size in ((0, 8), (8, 8), (4, 4)):
        got = port.train_batch_slice(ids, start, size)
        want = jax_.train_batch_slice(ids, start, size)
        for name in FIELDS:
            g = np.asarray(getattr(got, name))
            w = np.asarray(getattr(want, name))
            assert g.tobytes() == w.tobytes(), (name, start)


def test_host_batch_slice(monkeypatch):
    assert launch.host_batch_slice(512) == (0, 512)
    assert launch.all_reduce_sum([torch.ones(2)])[0].tolist() == [1.0, 1.0]
    monkeypatch.setattr(launch, "process_count", lambda: 4)
    monkeypatch.setattr(launch, "process_index", lambda: 3)
    assert launch.host_batch_slice(512) == (384, 128)
    with pytest.raises(ValueError, match="does not split"):
        launch.host_batch_slice(510)
    mesh = launch.global_mesh(model=2, devices=["cpu"] * 2)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.data_offset == 3


def run_multihost(*args, timeout=120):
    """The launcher's last JSON line; the whole session is stopped if the
    launcher outlives `timeout` seconds."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "sagnn_tpu_torch.parallel.multihost",
         "--device", "cpu", "--timeout", "100", *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=ROOT, env=env,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, err.decode()[-3000:]
    return json.loads([ln for ln in out.decode().splitlines()
                       if ln.startswith("{")][-1])


@pytest.mark.parametrize("procs", [2, 4])
def test_multihost_ring_passes_its_checksum(procs):
    res = run_multihost("--mode", "ring", "--procs", procs, "--edges",
                        60000, "--users", 4000, "--items", 3000, "--iters", 1)
    assert res["processes"] == procs and res["checksum_ok"] is True


def check_multihost_train(tmp_path, *flags):
    """Two processes, each sampling its half of every batch, against one
    process on a 2 x 1 mesh, both with the train `flags`: the epoch's
    losses and both evaluations."""
    res = run_multihost("--mode", "train", "--procs", 2, *flags)
    assert res["processes"] == 2 and res["steps"] == 2
    args = parse_args(["--mode", "train", *flags])
    tr = Trainer(train_config(args), load_bundle(args),
                 ckpt_root=str(tmp_path),
                 mesh=make_mesh(data=2, model=1, devices=["cpu"] * 2),
                 draws=args.draws)
    ref = tr.train_epoch(verbose=False)
    mets = tr.test_epoch()
    fs = tr.test_epoch(full_sort=True)
    for key, want in (("Loss", ref["Loss"]), ("preLoss", ref["preLoss"]),
                      ("HR", mets["HR"]), ("NDCG", mets["NDCG"]),
                      ("fs_HR", fs["HR"]), ("fs_NDCG", fs["NDCG"])):
        np.testing.assert_allclose(res[key], want, rtol=1e-4, err_msg=key)


def test_multihost_train_matches_the_single_process_mesh(tmp_path):
    check_multihost_train(tmp_path)


def test_multihost_train_with_jax_draws_matches_the_single_process_mesh(
        tmp_path):
    """`--draws jax` with the LSTM dropout on: every process draws the
    whole masks from the same JAX key and its rank takes its rows, as the
    one-process 2 x 1 mesh does (whose draws
    tests/test_torch_jax_draws_mesh.py holds to JAX's mesh Trainer)."""
    check_multihost_train(tmp_path, "--draws", "jax")
