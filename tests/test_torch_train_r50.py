"""One float32 training step of the port with the Bottleneck ResNet-50
(``BackboneConfig(depth=50)``, small: ``torch_parity.BACKBONES``, stage
widths (8, 16, 24, 32)) against the JAX package, by the method of
``test_torch_train_ol.py``: the JAX step in float64 is the exact answer,
and where JAX's float32 gradient is itself farther than the float32 bound
from it, the bound adds |JAX float32 - JAX float64|.

The weights are ``torch_parity``'s draw with the BatchNorm that ends each
residual branch scaled by ``R50_BRANCH_SCALE`` (0.1, the zero-gamma
practice of ResNet-50 training; ``torch_train_parity.problem``). At the
draw's scales near 1, 16 blocks of train-mode BatchNorm amplify float32
rounding about 1.3x a block in both packages, at every frame size and
batch tried: each package's float32 gradients then lie a median 1.3e-2 of
a leaf's largest entry from the float64 step, and no float32 bound could
be sharp.

Tolerances, those of the VIL step (measured in brackets): the matches
bit-equal; predictions and router scores within 1e-3 (8.4e-4); the loss
within 2e-5 relative (5.0e-7); each gradient leaf within 3e-3 of its
largest entry, plus 1e-5 (the routers' conv biases, zero up to rounding),
plus JAX's own float32 error (port against JAX at most 1.9e-4 of a leaf's
largest entry, 9.2e-5 on the backbone); the running statistics within
1e-5 (1.8e-6). The port's float64 step against JAX's: every leaf within
1e-5 of its largest entry (9.7e-7), the loss within 1e-7 relative
(1.1e-8), the outputs within 1e-5 (3.7e-6).
"""

import pytest

import torch_train_parity as ttp


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return ttp.f32_run("r50", tmp_path_factory.mktemp("jax_float64")
                       / "r50.npz")


def test_train_forward_matches(run):
    ttp.check_f32_forward(run)


def test_loss_matches(run):
    ref, got = run["ref"], run["got"]
    assert abs(got["loss"] - ref["loss"]) <= 2e-5 * abs(ref["loss"])


@pytest.mark.parametrize("name", ttp.leaf_names("r50"))
def test_leaf_gradient_matches(run, name):
    ttp.check_f32_leaf(run, name)


def test_batchnorm_running_stats_after_step(run):
    assert set(run["got"]["batch_stats"]) == set(run["ref"]["batch_stats"])
    ttp.check_f32_running_stats(run)


def test_branch_scales_are_small():
    """The problem's residual branches end in BatchNorm scales near
    ``R50_BRANCH_SCALE``; the other norms keep the draw's ~1."""
    _, tc, _, _ = ttp.configs("r50")
    variables, _, _ = ttp.problem("r50", tc)
    blocks = [b for k, b in variables["params"]["encoder"][
        "backbone"].items() if k.startswith("Bottleneck_")]
    assert len(blocks) == 16
    for b in blocks:
        last = abs(b["Norm_2"]["BatchNorm_0"]["scale"]).mean()
        first = abs(b["Norm_0"]["BatchNorm_0"]["scale"]).mean()
        assert last < 2 * ttp.R50_BRANCH_SCALE < 0.5 < first


def test_float64_step_matches_jax_float64(run):
    ttp.check_f64_step(run)


@pytest.mark.parametrize("name", ttp.leaf_names("r50"))
def test_float64_leaf_gradient_matches_jax_float64(run, name):
    ttp.check_f64_leaf(run, name)


def test_loss_against_float64(run):
    ttp.check_f32_loss_against_f64(run)
