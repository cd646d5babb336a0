"""One bf16 training step of OpenLane-V's multi-scale head
(``openlane_multiscale_config(compute_dtype="bfloat16")``,
``Router4OLV2``: the encoder in bf16, the head in float32, as the JAX
head reads no compute dtype), what ``train_ol.py --variant multiscale``
trains by default, at the small configuration of ``torch_parity``,
against an ``exact_jit`` JAX step, by the one-ulp method of
``torch_train_parity``: the port's step pinned to JAX's Hungarian
matches, each quantity held to twice the port's own one-ulp spread.

Tolerances as ``test_torch_train_ol_bf16.py``'s (measured ratios of
the gap to the port's one-ulp spread in brackets): the matches equal on
the robust slots (18 of 24 valid slots robust); the loss (0.14x), every
gradient leaf (at most 1.25x, ``encoder.backbone.blocks.1.bn0.weight``;
the head, in float32 here, at most 1.22x) and BatchNorm's running
statistics (0.75x) within ``FACTOR`` times the spread. The routers'
conv biases, which GroupNorm cancels (their gradients are zero up to
rounding, 1e-7 to 1e-6), are within ``FACTOR`` times the larger of both
packages' spreads (1.2x the port's).

Controls: the port's float32 step (5 running statistics and 1 leaf
outside) and BatchNorm's backward without the mean of the cotangent (2
leaves outside: the stem's BatchNorm scale and bias).
"""

import pytest

import phnet_torch.ops.batchnorm as tbn
import torch_train_parity as ttp

FACTOR = 2.0
ROBUST_MIN = 0.5  # robust share of the valid slots


@pytest.fixture(scope="module")
def run():
    return ttp.bf16_run("ms")


def test_outputs_reach_the_criterion_in_float32(run):
    ttp.check_outputs_float32(run)


def test_matches_on_robust_slots(run):
    ttp.check_robust_matches(run, ROBUST_MIN)


def test_loss_matches(run):
    ttp.check_loss(run, FACTOR)


@pytest.mark.parametrize("name", ttp.leaf_names("ms"))
def test_leaf_gradient_matches(run, name):
    ttp.check_leaf(run, name, FACTOR)


def test_batchnorm_running_stats(run):
    ttp.check_running_stats(run, FACTOR)


def test_float32_step_fails_the_bounds(run):
    f32 = ttp.control_step(run, "float32")
    assert ttp.stats_outside(run, f32, FACTOR)


def test_planted_fault_fails_the_bounds(run, monkeypatch):
    monkeypatch.setattr(tbn.BatchNormTrainFn, "backward",
                        ttp.without_mean_term(tbn.BatchNormTrainFn.backward))
    assert ttp.leaves_outside(run, ttp.control_step(run), FACTOR)
