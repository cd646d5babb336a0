"""One float32 training step of the port with the RevCol backbone
(``BackboneConfig(kind="revcol")``, small: ``torch_parity.BACKBONES``,
3 columns, the columns after the first checkpointed as ``save_memory``
makes them, drop path 0) against the JAX package, by the method of
``test_torch_train_ol.py``: the JAX step in float64 is the exact answer,
and where JAX's float32 gradient is itself farther than the float32 bound
from it, the bound adds |JAX float32 - JAX float64|.

Tolerances (measured in brackets): the matches bit-equal; predictions and
router scores within 1e-3 (1.8e-5); the loss within 2e-5 relative
(1.7e-7); each gradient leaf within 3e-3 of its largest entry, plus 1e-5
(the routers' conv biases, zero up to rounding), plus JAX's own float32
error (the backbone's leaves: port against JAX at most 1.5e-5 of the
largest entry). The port's float64 step against JAX's: every leaf within
1e-5 of its largest entry (1.6e-6 on the backbone), the loss within 1e-7
relative, the outputs within 1e-5 (1.7e-6). RevCol has no BatchNorm: the
encoder has no running statistics.
"""

import pytest
import torch

import torch_train_parity as ttp
from phnet_torch.models import PHNet


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return ttp.f32_run("revcol", tmp_path_factory.mktemp("jax_float64")
                       / "revcol.npz")


def test_train_forward_matches(run):
    ttp.check_f32_forward(run)


def test_loss_matches(run):
    ref, got = run["ref"], run["got"]
    assert abs(got["loss"] - ref["loss"]) <= 2e-5 * abs(ref["loss"])


@pytest.mark.parametrize("name", ttp.leaf_names("revcol"))
def test_leaf_gradient_matches(run, name):
    ttp.check_f32_leaf(run, name)


def test_no_running_statistics(run):
    assert not run["ref"]["batch_stats"] and not run["got"]["batch_stats"]
    _, tc, _, _ = ttp.configs("revcol")
    assert not list(PHNet(tc, device="cpu").encoder.buffers())


def test_float64_step_matches_jax_float64(run):
    ttp.check_f64_step(run)


@pytest.mark.parametrize("name", ttp.leaf_names("revcol"))
def test_float64_leaf_gradient_matches_jax_float64(run, name):
    ttp.check_f64_leaf(run, name)


def test_loss_against_float64(run):
    ttp.check_f32_loss_against_f64(run)


def test_columns_are_checkpointed():
    """The step above ran the port's column checkpoint: the configuration
    saves memory and has columns after the first."""
    _, tc, _, _ = ttp.configs("revcol")
    assert tc.backbone.revcol_save_memory and tc.backbone.revcol_num_subnet > 1
    assert tc.backbone.revcol_drop_path == 0.0
    assert torch.is_grad_enabled()
