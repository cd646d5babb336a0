"""One float32 training step of the port on OpenLane-V's single head
(``openlane_config()``, ``Router4OL``, at the small configuration of
``torch_parity``: the OL lane layout with one length field, learned
positions, a separate offset head, soft routing, a 2-frame ring, the
``blend_cls`` criterion with LaneIoU) against the JAX package, with
``tests/test_torch_train.py``'s float32 bounds:

* the matches bit-equal;
* predictions and router scores within 1e-3 (measured 3.8e-4);
* the loss within 2e-5 relative (measured 2.2e-6);
* each gradient leaf within 3e-3 of its largest entry (plus 1e-5 for the
  routers' conv biases, zero up to rounding), 3e-2 for the routers'
  chain parameters; BatchNorm's running statistics within 1e-5.

The exact answer is the JAX package's own step in float64
(``jax_float64_step.py``, run in a process of its own). The port's step
in float64 matches it: every gradient leaf within 1e-5 of its largest
entry (measured 1.2e-6; the routers' conv biases, zero up to rounding,
within 1e-12, measured 8e-16), the loss within 1e-7 relative (measured
2.5e-8), the outputs within 1e-5 (measured 3.4e-6), the matches equal.

Where JAX's float32 gradient is itself farther than the float32 bound
from the exact answer, the bound adds JAX's own distance from it, |JAX
float32 - JAX float64|, which does not move with the port. The gradients
of this configuration are less well conditioned than VIL's (the OL
criterion weighs cls by 8 and uses LaneIoU): JAX's float32 gradient is up
to 5.0e-2 of the largest entry from the exact one (0.6-2.2e-2 on the
encoder's leaves, where the port's is 1.3e-3 to 4.8e-3). On every leaf
that needs the allowance, JAX's float32 error is at least twice the
port's (measured 2.3x at the least: :func:`test_jax_float32_is_the_
farther_from_float64`).
"""

import pytest

import torch_train_parity as ttp


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return ttp.f32_run("ol", tmp_path_factory.mktemp("jax_float64")
                       / "ol.npz")


def test_train_forward_matches(run):
    ttp.check_f32_forward(run)


def test_loss_matches(run):
    ref, got = run["ref"], run["got"]
    assert abs(got["loss"] - ref["loss"]) <= 2e-5 * abs(ref["loss"])


@pytest.mark.parametrize("name", ttp.leaf_names("ol"))
def test_leaf_gradient_matches(run, name):
    ttp.check_f32_leaf(run, name)


def test_batchnorm_running_stats_after_step(run):
    ttp.check_f32_running_stats(run)


def test_float64_step_matches_jax_float64(run):
    """The port's float64 step against JAX's: matches, loss, outputs."""
    ttp.check_f64_step(run)


@pytest.mark.parametrize("name", ttp.leaf_names("ol"))
def test_float64_leaf_gradient_matches_jax_float64(run, name):
    ttp.check_f64_leaf(run, name)


def test_loss_against_float64(run):
    """The port's float32 loss within 1e-5 relative of the exact one
    (measured 1.6e-7; JAX's 2.3e-6)."""
    ttp.check_f32_loss_against_f64(run)


def test_jax_float32_is_the_farther_from_float64(run):
    """On the leaves where the port is farther from JAX than the float32
    bound, JAX's float32 gradient is at least twice as far from the exact
    one as the port's."""
    assert ttp.check_jax_is_the_farther(run) > 0
