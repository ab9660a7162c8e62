"""The port's all-gather edge partition and the ring's host-plan wrappers
against the JAX package on the CPU: `partition_edges_by_target` and
`pad_node_table` byte for byte, `edge_partitioned_spmm` /
`edge_partitioned_propagate` and `ring_edge_partitioned_spmm` /
`ring_edge_partitioned_propagate` forward and gradient.

The JAX side runs on a mesh of the 8 forced CPU devices
(tests/conftest.py), data × model with the same model axis; the port runs
on a mesh of CPU ranks (`make_mesh(model=P, devices=["cpu"] * P)`), where
each rank's K1 (or K6) takes its plain version. Tolerances: rtol 1e-5 and
atol 1e-5·sqrt(max degree), as JAX's own edge-partition tests hold a hop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagnn_tpu.parallel import edge_partition as jep
from sagnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from sagnn_tpu_torch.ops import spmm_cuda as sc
from sagnn_tpu_torch.parallel import edge_partition as ep
from sagnn_tpu_torch.parallel import sharding
from sagnn_tpu_torch.parallel.mesh import make_mesh

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

U, I, D, E = 300, 250, 16, 4000


def _graph(seed):
    """A target-sorted COO into U targets from I sources, with pad edges
    (tgt == U) at the end, and a target cotangent G."""
    rng = np.random.default_rng(seed)
    tgt = np.sort(rng.integers(0, U, E)).astype(np.int32)
    src = rng.integers(0, I, E).astype(np.int32)
    x = rng.standard_normal((I, D)).astype(np.float32)
    g = rng.standard_normal((U, D)).astype(np.float32)
    w = (rng.random(E) + 0.25).astype(np.float32)
    pad_s, pad_t = np.zeros(5, np.int32), np.full(5, U, np.int32)
    return (np.concatenate([src, pad_s]), np.concatenate([tgt, pad_t]), x,
            g, w)


def _atol(tgt, src):
    deg = max(np.bincount(tgt[tgt < U]).max(), np.bincount(src).max())
    return 1e-5 * np.sqrt(deg)


def _j_put(x, mesh):
    sh = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("model", None))
    return jax.device_put(jnp.asarray(x), sh)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_partition_edges_by_target_matches_jax(shards):
    src, tgt, x, _, _ = _graph(shards)
    got = ep.partition_edges_by_target(src, tgt, U, shards)
    want = jep.partition_edges_by_target(src, tgt, U, shards)
    assert got.src.dtype == want.src.dtype == np.int32
    assert got.src.tobytes() == want.src.tobytes()
    assert got.tgt_local.tobytes() == want.tgt_local.tobytes()
    assert (got.rows_per_shard, got.num_tgt, got.num_shards) == (
        want.rows_per_shard, want.num_tgt, want.num_shards)
    for n in (shards, 3):
        a, b = ep.pad_node_table(x, n), jep.pad_node_table(x, n)
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("shards", [2, 4])
def test_edge_partitioned_spmm_and_grad_match_jax(shards):
    """The AG propagate (leaky 0.2, so every block's sum shows through)
    and the gradient of <propagate, G> in the blocks, against JAX's
    shard_map and its VJP (jitted); the hop is the tensor-parallel hop,
    and a prebuilt one gives what a call that builds its own does."""
    src, tgt, x, g, _ = _graph(10 + shards)
    parts = ep.partition_edges_by_target(src, tgt, U, shards)
    jparts = jep.partition_edges_by_target(src, tgt, U, shards)
    xp = ep.pad_node_table(x, shards)
    jmesh = j_make_mesh(data=8 // shards, model=shards)
    x_dev = _j_put(xp, jmesh)
    with jmesh:
        want, vjp = jax.vjp(jax.jit(lambda xx: jep.edge_partitioned_propagate(
            jmesh, xx, jparts, 0.2)), x_dev)
        want_dx = np.asarray(vjp(jnp.asarray(g))[0])

    mesh = make_mesh(model=shards, devices=["cpu"] * shards)
    hop = ep.ag_hop(parts, mesh, xp.shape[0] // shards)
    assert isinstance(hop, sharding.TPHop) and len(hop.fwd) == shards
    blocks = [b.requires_grad_() for b in
              ep.shard(torch.from_numpy(xp), xp.shape[0] // shards, mesh)]
    out = ep.edge_partitioned_propagate(blocks, parts, mesh, 0.2, hop=hop)
    assert out.shape == (U, D)
    assert torch.equal(out, ep.edge_partitioned_propagate(blocks, parts,
                                                          mesh, 0.2))
    atol = _atol(tgt, src)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=atol)
    (out * torch.from_numpy(g)).sum().backward()
    got_dx = torch.cat([b.grad for b in blocks]).numpy()
    np.testing.assert_allclose(got_dx, want_dx, rtol=1e-5, atol=atol)


def test_ag_hop_bf16_table_and_checks():
    """bf16 blocks take K1's bf16 table mode (the plain version sums the
    bf16-rounded table in f32); a source id past the gathered rows and a
    mesh of another size are refused."""
    src, tgt, x, _, _ = _graph(20)
    parts = ep.partition_edges_by_target(src, tgt, U, 2)
    xp = ep.pad_node_table(x, 2)
    mesh = make_mesh(model=2, devices=["cpu"] * 2)
    rows = xp.shape[0] // 2
    blocks = ep.shard(torch.from_numpy(xp).bfloat16(), rows, mesh)
    got = torch.cat(ep.edge_partitioned_spmm(blocks, parts, mesh))
    ref = sc.spmm_apply_plain(
        torch.from_numpy(xp), torch.from_numpy(src[:E]),
        torch.from_numpy(sc.csr_row_ptr(tgt[:E], U)), exact=False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got[:U].numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-5)
    with pytest.raises(ValueError, match="outside"):
        ep.ag_hop(parts, mesh, 100)
    with pytest.raises(ValueError, match="shards"):
        ep.ag_hop(parts, make_mesh(model=4, devices=["cpu"] * 4), rows)
    with pytest.raises(ValueError, match="'model'"):
        ep.edge_partitioned_spmm(blocks, parts, mesh, axis="data")


@pytest.mark.parametrize("weighted", [False, True])
def test_ring_edge_partitioned_wrappers_match_jax(weighted):
    """The ring wrappers over one RingEdgePartitions (weighted: per-edge
    values in the partitions) against JAX's ring_spmm_arrays on a 2 x 4
    mesh (jitted): the propagate and the gradient of <propagate, G>,
    through prebuilt plans and through plans the call builds."""
    P = 4
    src, tgt, x, g, w = _graph(30 + weighted)
    wts = np.concatenate([w, np.zeros(5, np.float32)]) if weighted else None
    parts = ep.partition_edges_ring(src, tgt, I, U, P, weights=wts)
    jparts = jep.partition_edges_ring(src, tgt, I, U, P, weights=wts)
    srows = parts.src_rows_per_shard
    xp = jep.pad_node_table_rows(x, P, srows)
    jmesh = j_make_mesh(data=2, model=P)
    x_dev = _j_put(xp, jmesh)
    with jmesh:
        want, vjp = jax.vjp(jax.jit(
            lambda xx: jep.ring_edge_partitioned_propagate(
                jmesh, xx, jparts, 0.2)), x_dev)
        want_dx = np.asarray(vjp(jnp.asarray(g))[0])
    mesh = make_mesh(model=P, devices=["cpu"] * P)
    blocks = [b.requires_grad_()
              for b in ep.shard(torch.from_numpy(x), srows, mesh)]
    out = ep.ring_edge_partitioned_propagate(
        blocks, parts, mesh, 0.2, plans=ep.ring_edge_plans(parts, mesh))
    assert torch.equal(out, ep.ring_edge_partitioned_propagate(
        blocks, parts, mesh, 0.2))
    atol = _atol(tgt, src)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=atol)
    (out * torch.from_numpy(g)).sum().backward()
    got_dx = torch.cat([b.grad for b in blocks]).numpy()
    np.testing.assert_allclose(got_dx, want_dx, rtol=1e-5, atol=atol)
