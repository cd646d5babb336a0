"""One bf16 training step of OpenLane-V's single head
(``openlane_config(compute_dtype="bfloat16")``, what ``train_ol.py``
trains by default, at the small configuration of ``torch_parity``)
against an ``exact_jit`` JAX step, by the one-ulp method of
``torch_train_parity``.

Tolerances as ``test_torch_train_bf16.py``'s (measured ratios of the gap
to the spread in brackets): the matches equal on the robust slots (15 of
24 valid slots robust); the loss (0.55x), every gradient leaf (at most
1.16x, the routers' 0.74x) and BatchNorm's running statistics (0.75x)
within ``FACTOR`` times the port's one-ulp spread; the routers' conv
biases (zero up to rounding: 7e-3 to 1.2e-2 of the taps' in JAX, 1.1e-3
to 1.7e-3 in the port) within ``FACTOR`` times the larger of the port's
and JAX's spread (0.62-0.70x).

Controls: the port's float32 step (5 running statistics and 1 leaf
outside; the first block's mean 8.8e-4 of its largest entry from JAX's,
the bf16 step's 1.7e-5, a one-ulp copy's 1.0e-4); BatchNorm's backward
without the mean of the cotangent (6 leaves outside, the stem's
BatchNorm bias at 5.2x its bound).
"""

import pytest

import phnet_torch.ops.batchnorm as tbn
import torch_train_parity as ttp

FACTOR = 2.0
ROBUST_MIN = 0.5  # robust share of the valid slots


@pytest.fixture(scope="module")
def run():
    return ttp.bf16_run("ol")


def test_outputs_reach_the_criterion_in_float32(run):
    ttp.check_outputs_float32(run)


def test_matches_on_robust_slots(run):
    ttp.check_robust_matches(run, ROBUST_MIN)


def test_loss_matches(run):
    ttp.check_loss(run, FACTOR)


@pytest.mark.parametrize("name", ttp.leaf_names("ol"))
def test_leaf_gradient_matches(run, name):
    ttp.check_leaf(run, name, FACTOR)


def test_batchnorm_running_stats(run):
    ttp.check_running_stats(run, FACTOR)


def test_float32_step_fails_the_bounds(run):
    """The port's float32 step posing as the bf16 one: its running
    statistics are outside the bounds."""
    f32 = ttp.control_step(run, "float32")
    assert ttp.stats_outside(run, f32, FACTOR)


def test_planted_fault_fails_the_bounds(run, monkeypatch):
    """A step whose BatchNorm backward drops the mean of the cotangent:
    gradient leaves are outside their bounds."""
    monkeypatch.setattr(tbn.BatchNormTrainFn, "backward",
                        ttp.without_mean_term(tbn.BatchNormTrainFn.backward))
    assert ttp.leaves_outside(run, ttp.control_step(run), FACTOR)

