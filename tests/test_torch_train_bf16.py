"""One bf16 training step of the port (``vil100_config(compute_dtype=
"bfloat16")`` at the small configuration, the JAX trainers' default)
against an ``exact_jit`` JAX step, by the one-ulp method of
``torch_train_parity`` (the matches and the routers' output gates pinned
to JAX's).

Tolerances (measured ratios of the gap to the spread in brackets):

* the matches equal on the robust slots (19 of 24 valid slots robust);
* the loss (0.32x), every gradient leaf (at most 1.35x, the routers'
  1.05x) and BatchNorm's running statistics (0.77x) within ``FACTOR``
  times the port's one-ulp spread;
* the routers' conv biases, whose gradient is zero up to rounding (2.1e-2
  to 1.5e-2 of the taps' in JAX, whose chain rounds every product and sum
  of a 3x3; 3.6e-3 to 2.2e-3 in the port), within ``FACTOR`` times the
  larger of the port's spread and JAX's (0.51-0.60x).

With the gates unpinned the stage-2 router's MLP was 2.6x the port's
spread from JAX: two of its 32 anchors' gates (the ReLU before the
sigmoid) were open in one package and closed in the other, each moving
that anchor's whole contribution; with the gates pinned it is 0.40x.

Controls, which the bounds must reject: the port's float32 step (its
gradients and loss are inside the bounds, but 6 running statistics are
outside: the first block's mean 9.2e-4 of its largest entry from JAX's,
where the bf16 step is at 8.3e-6 and a one-ulp copy at 9.5e-5); a step
whose BatchNorm backward drops the mean of the cotangent (9 leaves
outside, the stem's BatchNorm bias at 9.0x its bound). Dropping the
backward's other term (``x_hat * mean(g * x_hat)``) stays inside the
bounds; ``test_torch_batchnorm.py`` holds that formula against JAX's
VJP.
"""

import pytest

import phnet_torch.ops.batchnorm as tbn
import torch_train_parity as ttp

FACTOR = 2.0
ROBUST_MIN = 0.5  # robust share of the valid slots


@pytest.fixture(scope="module")
def run():
    return ttp.bf16_run("vil")


def test_outputs_reach_the_criterion_in_float32(run):
    ttp.check_outputs_float32(run)


def test_matches_on_robust_slots(run):
    ttp.check_robust_matches(run, ROBUST_MIN)


def test_loss_matches(run):
    ttp.check_loss(run, FACTOR)


@pytest.mark.parametrize("name", ttp.leaf_names("vil"))
def test_leaf_gradient_matches(run, name):
    ttp.check_leaf(run, name, FACTOR)


def test_batchnorm_running_stats(run):
    ttp.check_running_stats(run, FACTOR)


# -- controls: steps the bounds must reject ---------------------------------

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

