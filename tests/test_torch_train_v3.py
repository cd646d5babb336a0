"""One float32 training step of the port on OpenLane-V's prior-propagation
head (``openlane_propagate_config()``, ``Router4OLV3``, what ``train_ol.py
--variant propagate --fp32`` trains, at the small configuration of
``torch_parity.small_v3_cfg``) against the JAX package, by the method of
``test_torch_train_ol.py`` (the JAX step in float64 as the exact answer).

The step's second frame propagates the first frame's matched lanes: the
carry is the last stage's second-branch matches at every stage, detached
(the ring's write keeps its gradient), with an unmatched slot's index
clipped to row 0 as JAX clips it; the MLP routers' input keeps its
gradient. The carry after the step is held too.

Tolerances (measured in brackets): the matches bit-equal; predictions and
router scores within 1e-3 (4.2e-4); the carry's features and priors
within 1e-3, its mask equal; the loss within 2e-5 relative (6.1e-6);
each gradient leaf within 3e-3 of its largest entry plus 1e-5 plus JAX's
own float32 error; BatchNorm's running statistics within 1e-5. The
port's float64 step against JAX's: the outputs within 1e-5 (3.6e-6), the
loss within 1e-7 relative (1.8e-8), every gradient leaf within
:data:`F64_LEAF` of its largest entry (1.1e-5, on ``heads_sec.out1_bias``:
the propagated rows' priors are the previous frame's predictions, which
carry the packages' float32 constants on).
"""

import numpy as np
import pytest

import torch_train_parity as ttp

F64_LEAF = 3e-5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return ttp.f32_run("v3", tmp_path_factory.mktemp("jax_float64")
                       / "v3.npz")


def test_train_forward_matches(run):
    ttp.check_f32_forward(run)
    a, k = 32, 4
    assert run["got"]["outs"].pred_fir.shape[3] == a + k


@pytest.mark.parametrize("name", ["feat", "priors", "mask"])
def test_carry_after_step(run, name):
    """The one-frame carry after the step: features and priors within
    1e-3, the mask equal (and some slot valid: the labels' valid
    column)."""
    g = getattr(run["got"]["mem"], name).detach().numpy()
    r = np.asarray(getattr(run["ref"]["mem"], name))
    assert g.shape == r.shape
    if name == "mask":
        np.testing.assert_array_equal(g, r)
        assert g.any() and not g.all()
    else:
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-3)


def test_loss_matches(run):
    ref, got = run["ref"], run["got"]
    assert abs(got["loss"] - ref["loss"]) <= 2e-5 * abs(ref["loss"])


@pytest.mark.parametrize("name", ttp.leaf_names("v3"))
def test_leaf_gradient_matches(run, name):
    ttp.check_f32_leaf(run, name)


def test_batchnorm_running_stats_after_step(run):
    ttp.check_f32_running_stats(run)


def test_float64_step_matches_jax_float64(run):
    ttp.check_f64_step(run)


@pytest.mark.parametrize("name", ttp.leaf_names("v3"))
def test_float64_leaf_gradient_matches_jax_float64(run, name):
    ttp.check_f64_leaf(run, name, F64_LEAF)


def test_loss_against_float64(run):
    ttp.check_f32_loss_against_f64(run)


def test_jax_float32_is_the_farther_from_float64(run):
    assert ttp.check_jax_is_the_farther(run) > 0


def test_propagated_heads_learn(run):
    """The "_last" stacks, their decoder and the MLP routers get a
    gradient once the carry holds rows (the second frame), in both
    packages (``test_head_v3.py::test_train_loss_and_grads``)."""
    for prefix in ("head.heads_fir_last.", "head.heads_sec_last.",
                   "head.temporal_decoder_last.", "head.mlp_routers.0."):
        for pkg in ("ref", "got"):
            assert any(np.abs(g).max() > 0 for n, g in run[pkg][
                "grads"].items() if n.startswith(prefix)), (pkg, prefix)
