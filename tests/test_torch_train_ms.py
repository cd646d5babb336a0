"""One float32 training step of the port on OpenLane-V's multi-scale head
(``openlane_multiscale_config()``, ``Router4OLV2``, what ``train_ol.py
--variant multiscale --fp32`` trains, at the small configuration of
``torch_parity.small_ms_cfg``) against the JAX package, by the method of
``test_torch_train_ol.py``: the JAX step in float64 is the exact answer,
and where JAX's float32 gradient is itself farther than the float32 bound
from it, the bound adds |JAX float32 - JAX float64|.

Tolerances (measured in brackets): the matches bit-equal; predictions and
router scores within 1e-3 (5.1e-4); the loss within 2e-5 relative
(7.8e-6); each gradient leaf within 3e-3 of its largest entry, plus 1e-5
(the routers' conv biases, which GroupNorm cancels: their gradients are
zero up to rounding, 6e-9 to 1.5e-7), plus JAX's own float32 error (up to
0.11 of the largest entry, on ``dyn_heads.1``); BatchNorm's running
statistics within 1e-5. The port's float64 step against JAX's: every
leaf within 1e-5 of its largest entry (5.1e-6), the loss within 1e-7
relative (3.4e-8), the outputs within :data:`F64_OUT_ATOL` (1.5e-5: the
third stage samples the stride-4 level, which amplifies the packages'
float32 constants, ``tests/test_torch_head_ms.py``).

The backbone's last stage is not read by this head: the loss does not
reach its parameters, JAX's gradient there is zero, and the port's
optimizer gives them a zero gradient so that AdamW's weight decay moves
them as the JAX update does (:func:`test_unused_stage_decays_as_jax`).
"""

import numpy as np
import pytest
import torch

import phnet_torch.config as tcfg
import torch_train_parity as ttp

F64_OUT_ATOL = 5e-5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return ttp.f32_run("ms", tmp_path_factory.mktemp("jax_float64")
                       / "ms.npz")


def test_train_forward_matches(run):
    ttp.check_f32_forward(run)


def test_loss_matches(run):
    ref, got = run["ref"], run["got"]
    assert abs(got["loss"] - ref["loss"]) <= 2e-5 * abs(ref["loss"])


@pytest.mark.parametrize("name", ttp.leaf_names("ms"))
def test_leaf_gradient_matches(run, name):
    ttp.check_f32_leaf(run, name)


def test_batchnorm_running_stats_after_step(run):
    ttp.check_f32_running_stats(run)


def test_float64_step_matches_jax_float64(run):
    ttp.check_f64_step(run, F64_OUT_ATOL)


@pytest.mark.parametrize("name", ttp.leaf_names("ms"))
def test_float64_leaf_gradient_matches_jax_float64(run, name):
    ttp.check_f64_leaf(run, name)


def test_loss_against_float64(run):
    ttp.check_f32_loss_against_f64(run)


def test_jax_float32_is_the_farther_from_float64(run):
    assert ttp.check_jax_is_the_farther(run) > 0


def test_unused_stage_decays_as_jax(run):
    """The last backbone stage: no gradient reaches it (JAX's is zero),
    and one optimizer update moves it by weight decay alone, as
    ``optax.adamw`` does on a zero gradient: p * (1 - lr * wd)."""
    from phnet_torch.train.optimizer import build_optimizer

    stage = "encoder.backbone.blocks.7.conv1.weight"
    assert not np.abs(run["ref"]["grads"][stage]).any()
    cfg = tcfg.openlane_multiscale_config()
    _, tc, _, _ = ttp.configs("ms")
    model = torch.nn.Linear(2, 2)  # a parameter the loss never reaches
    opt = build_optimizer(cfg.train, 10, model.parameters())
    before = model.weight.detach().clone()
    opt.step()
    lr, wd = cfg.train.learning_rate, cfg.train.weight_decay
    torch.testing.assert_close(model.weight.detach(),
                               before * (1 - lr * wd), rtol=1e-6, atol=0)
    assert tc.backbone.out_indices == (0, 1, 2)
