"""One bf16 VIL training step with ``router_train_chain_f32=True`` (the
router's chain in float32 inside the bf16 model, the JAX package's switch
``HeadConfig.router_train_chain_f32``) against an ``exact_jit`` JAX step
with the same flag, by the one-ulp method of ``torch_train_parity``.

Tolerances as ``test_torch_train_bf16.py``'s (measured ratios of the gap
to the spread in brackets): the matches equal on the robust slots (20 of
24 valid slots robust); the loss (0.07x), every gradient leaf (at most
1.49x, the routers' 1.00x) and BatchNorm's running statistics (0.77x)
within ``FACTOR`` times the port's one-ulp spread. With the float32 chain
the conv biases' gradient is zero up to float32 rounding (1.3e-7 to
3.1e-7 of the taps' on both sides; 0.45-0.63x of the larger spread).

Controls as ``test_torch_train_bf16.py``'s: the port's float32 step (6
running statistics outside) and BatchNorm's backward without the mean of
the cotangent (10 leaves outside, the stem's bias at 9.5x its bound).
"""

import pytest

import phnet_torch.ops.batchnorm as tbn
import torch_train_parity as ttp

FACTOR = 2.0
ROBUST_MIN = 0.5  # robust share of the valid slots


@pytest.fixture(scope="module")
def run():
    return ttp.bf16_run("vil", chain_f32=True)


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

