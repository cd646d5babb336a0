"""One float32 training step of the port under the dynamic-k assigner
(``ModelConfig.train_assigner="dynamic_k"``) against the JAX package's, at
VIL's small configuration (``torch_train_parity``: one clip of 2 frames,
decoder dropout 0). One JAX step compile.

The two packages' float32 predictions differ by ~1e-5 (train-mode
BatchNorm on two small frames amplifies rounding, ``test_torch_train.py``),
and the dynamic-k match keeps each target's cheapest matched prior, so a
near-tie between two priors can go either way (measured: 1 of the 48
matches, two priors whose costs are 1.3e-4 apart). So:

* the port's assigner on JAX's own predictions gives JAX's matches,
  bit-equal, every branch, stage and frame;
* the port's free step differs from JAX's matches only where JAX's costs
  of the two priors are within 1e-3 of each other;
* with the assignment pinned to JAX's matches (``pinned_assignment``),
  ``test_torch_train.py``'s bounds: the loss within 2e-5 relative, each
  gradient leaf within ``leaf_tolerance`` of its largest entry plus 1e-5,
  BatchNorm's running statistics within 1e-5."""

import dataclasses

import numpy as np
import pytest
import torch

from phnet_torch.losses.assign import _cost_and_iou, dynamic_k_frame
from torch_train_parity import (configs, jax_step, leaf_tolerance,
                                port_matches, port_step, problem)

NEAR_TIE = 1e-3


@pytest.fixture(scope="module")
def run():
    jc, tc, jl, tl = configs("vil")
    jc = dataclasses.replace(jc, train_assigner="dynamic_k")
    tc = dataclasses.replace(tc, train_assigner="dynamic_k")
    variables, frames, labels = problem("vil", tc)
    ref = jax_step(jc, jl, variables, labels)(frames)
    return dict(
        tc=tc, labels=labels, ref=ref,
        free=port_matches(tc, variables, frames, labels),
        pinned=port_step(tc, tl, variables, frames, labels,
                         pin=ref["matches"]),
        hungarian=port_matches(configs("vil")[1], variables, frames,
                               labels))


def jax_predictions(run) -> torch.Tensor:
    """JAX's predictions [2, T, S, B, A, dim] (first, second branch)."""
    outs = run["ref"]["outs"]
    return torch.from_numpy(np.stack([np.asarray(outs.pred_fir),
                                      np.asarray(outs.pred_sec)]))


def targets(run):
    """Labels [1, T, 1, B, L, dim] and validity, broadcast over the
    predictions' branch and stage dimensions."""
    lab = torch.from_numpy(run["labels"]).transpose(0, 1)[None, :, None]
    return lab, lab[..., 1] == 1.0


def test_assigner_on_jax_predictions_is_bit_equal(run):
    tc = run["tc"]
    lab, valid = targets(run)
    got = dynamic_k_frame(jax_predictions(run), lab, valid, tc.lane,
                          tc.img_w, tc.img_h)
    np.testing.assert_array_equal(got.numpy(), run["ref"]["matches"])
    # the assigner is not the Hungarian one in disguise
    assert (run["ref"]["matches"] != run["hungarian"]).any()


def test_free_matches_differ_only_at_near_ties(run):
    tc = run["tc"]
    lab, valid = targets(run)
    cost, _ = _cost_and_iou(jax_predictions(run), lab, valid, tc.lane,
                            tc.img_w, tc.img_h)  # [2, T, S, B, A, L]
    ref, free = run["ref"]["matches"], run["free"]
    live = np.broadcast_to(valid.numpy(), ref.shape)
    for idx in np.argwhere((ref != free) & live):
        br, t, s, b, l = idx
        c = cost[br, t, s, b, :, l]
        gap = abs(float(c[ref[tuple(idx)]] - c[free[tuple(idx)]]))
        assert gap <= NEAR_TIE, (tuple(idx), gap)


def test_loss_matches(run):
    ref, got = run["ref"]["loss"], run["pinned"]["loss"]
    assert np.isfinite(got) and abs(got - ref) <= 2e-5 * abs(ref)


def test_gradient_leaves_match(run):
    ref, got = run["ref"]["grads"], run["pinned"]["grads"]
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape, name
        bound = leaf_tolerance(name) * np.abs(r).max() + 1e-5
        assert np.abs(g - r).max() <= bound, (name, np.abs(g - r).max(),
                                              bound)


def test_running_stats_match(run):
    ref, got = run["ref"]["batch_stats"], run["pinned"]["batch_stats"]
    assert ref and sorted(got) == sorted(ref)
    for k, x in ref.items():
        np.testing.assert_allclose(got[k], x, rtol=0, atol=1e-5, err_msg=k)
