"""One bf16 training step of OpenLane-V's prior-propagation head
(``openlane_propagate_config(compute_dtype="bfloat16")``,
``Router4OLV3``), what ``train_ol.py --variant propagate`` trains by
default, at the small configuration of ``torch_parity``,
against an ``exact_jit`` JAX step, by the one-ulp method of
``torch_train_parity``: the port's step pinned to JAX's Hungarian
matches, each quantity held to twice the port's own one-ulp spread.

Six one-ulp copies (:data:`ULP_SEEDS`), not three: with three, the
port's spread of ``dyn_heads.0.norm1.bias`` came out at 0.52 and its gap
to JAX (1.07) at 2.05x; six copies put the spread at 0.98 (1.09x), and
every other leaf is within 1.08x with either.

Tolerances (measured ratios of the gap to the port's one-ulp spread in
brackets): the matches equal on the robust slots (20 of 24 valid slots
robust); the loss (0.30x), every gradient leaf (at most 1.09x; the
"_last" stacks, their decoder and the MLP routers at most 1.08x) and
BatchNorm's running statistics (0.74x) within ``FACTOR`` times the
spread.

Controls: the port's float32 step (5 running statistics and 1 leaf
outside) and BatchNorm's backward without the mean of the cotangent (2
leaves outside: the stem's BatchNorm bias, block 3's second).
"""

import pytest

import phnet_torch.ops.batchnorm as tbn
import torch_train_parity as ttp

FACTOR = 2.0
ROBUST_MIN = 0.5  # robust share of the valid slots
ULP_SEEDS = tuple(range(5, 11))


@pytest.fixture(scope="module")
def run():
    return ttp.bf16_run("v3", ulp_seeds=ULP_SEEDS)


def test_outputs_reach_the_criterion_in_float32(run):
    ttp.check_outputs_float32(run)


def test_matches_on_robust_slots(run):
    ttp.check_robust_matches(run, ROBUST_MIN)


def test_loss_matches(run):
    ttp.check_loss(run, FACTOR)


@pytest.mark.parametrize("name", ttp.leaf_names("v3"))
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
