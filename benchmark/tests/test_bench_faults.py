"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have (tiny size, on the CPU; the look for a card
is skipped by calling the run below it): a training step that returns its
state unchanged, half of the batch left out with the mean over the rest,
the segment-sum kernel's backward scaled, and a served answer altered
where it is produced. (No cell spans chips, so
there is no exchange between chips to leave out.)"""

from __future__ import annotations

import dataclasses

import pytest

from test_bench_reference import run_tiny


@pytest.mark.parametrize("name", ["gowalla.train", "yelp.train"])
def test_step_that_keeps_its_state(name, monkeypatch, cpu_threads):
    from sagnn_tpu_torch.train import optim

    def unchanged(self, params, grads, state):
        return None

    monkeypatch.setattr(optim.TF1Adam, "step", unchanged)
    out = run_tiny(name)
    assert not out["correct"]
    assert out["check"]["grad_med_gap"]["value"] > \
        out["check"]["grad_med_gap"]["limit"]


@pytest.mark.parametrize("name", ["gowalla.train", "yelp.train"])
def test_half_the_batch_left_out(name, monkeypatch, cpu_threads):
    from sagnn_tpu_torch.models import selfgnn

    losses = selfgnn.SelfGNN.train_losses

    def half(self, params, graphs, batch, gen=None, masks=None):
        mask = batch.pair_mask.clone()
        mask[mask.shape[0] // 2:] = 0
        return losses(self, params, graphs,
                      dataclasses.replace(batch, pair_mask=mask), gen, masks)

    monkeypatch.setattr(selfgnn.SelfGNN, "train_losses", half)
    out = run_tiny(name)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("name", ["gowalla.train", "yelp.train"])
def test_segment_sum_backward_scaled(name, monkeypatch, cpu_threads):
    """K1's dx off by 2% reaches only the propagated tables' gradients."""
    from sagnn_tpu_torch.ops import spmm_cuda

    backward = spmm_cuda.SpmmFunction.backward

    def scaled(ctx, g):
        dx, *rest = backward(ctx, g)
        return (None if dx is None else dx * 1.02, *rest)

    monkeypatch.setattr(spmm_cuda.SpmmFunction, "backward",
                        staticmethod(scaled))
    out = run_tiny(name)
    assert not out["correct"]
    gap = out["check"]["grad_embed_gap"]
    assert gap["value"] > gap["limit"], out["check"]


@pytest.mark.parametrize("name", ["gowalla.serve", "yelp.serve"])
def test_answer_altered(name, monkeypatch, cpu_threads):
    from sagnn_tpu_torch.models import selfgnn

    top_k = selfgnn.SelfGNN.recommend_top_k

    def altered(self, *args, **kwargs):
        scores, ids = top_k(self, *args, **kwargs)
        ids = ids.clone()
        ids[0, -1] = (ids[0, -1] + 1) % self.num_items
        return scores, ids

    monkeypatch.setattr(selfgnn.SelfGNN, "recommend_top_k", altered)
    out = run_tiny(name)
    assert not out["correct"], out["check"]
