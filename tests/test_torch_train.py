"""One training step of the port against the JAX package at the small
configuration (``torch_parity``), decoder dropout 0, one clip of 2 frames.

The JAX side is ``make_train_step``'s loss function (``model.apply(...,
train=True, mutable=["batch_stats"])`` then ``LaneCriterion``),
differentiated once; its gradient norm is ``optax.global_norm``, what the
step reports. The port runs ``PHNet.train_forward`` (remat on, its
default) and its criterion. Both take the same numpy weights, frames and
labels.

Tolerances, from measurements of this configuration (and the port run
again in float64 as the exact answer):

* the matches (``matched_fir`` / ``matched_sec``) bit-equal, so the
  memory mask too;
* predictions, router scores and memory values within 1e-3: BatchNorm on
  the statistics of 2 small frames amplifies the float32 rounding of two
  implementations (the encoder's levels differ by ~1e-5 relative in train
  mode, 5e-7 in eval mode);
* the loss within 2e-5 relative: JAX's float32 loss is itself 1.1e-5
  relative from the float64 one (the port's 1.9e-6), and under a 1e-6
  relative perturbation of the frames each side's loss moves ~9e-6
  relative;
* each gradient leaf within 3e-3 of its largest entry (plus 1e-5 for the
  leaves that are zero up to rounding, the router's conv biases that a
  LayerNorm cancels). The router's chain parameters (``taps``,
  ``ln_params``) get 3e-2: there JAX's float32 gradient is 1.5e-2 from the
  float64 one where the port's is 2e-5 (``test_jax_float32_is_the_
  farther_from_float64``; ``test_port_float32_against_float64`` holds the
  port to 2e-3 on every leaf);
* the gradient norm within 1e-4 relative, BatchNorm's running statistics
  within 1e-5.

A missing stop-gradient changes the leaves upstream of it by far more than
these bounds while the loss stays the same: only the leaf test sees it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import phnet_torch.config as tcfgmod
import phnet_tpu.config as jcfgmod
import torch_parity as tp
from torch_train_parity import leaf_tolerance
from phnet_torch.convert import convert
from phnet_torch.losses.criterion import LaneCriterion as TorchCriterion
from phnet_torch.models import PHNet as TorchPHNet
from phnet_tpu.losses import LaneCriterion as JaxCriterion
from phnet_tpu.models import PHNet as JaxPHNet

B, T = 1, 2


def cfgs():
    j, t = tp.jax_cfg(), tp.torch_cfg()
    # JAX without remat: the same function, compiled faster
    j = dataclasses.replace(j, head=dataclasses.replace(
        j.head, decoder_dropout=0.0), remat_frames=False)
    t = dataclasses.replace(t, head=dataclasses.replace(
        t.head, decoder_dropout=0.0))
    return j, t


def clip_labels(rng, b, t, spec, max_lanes=4):
    """Two lanes a frame, pixel xs in the 128-wide image."""
    lab = np.full((b, t, max_lanes, spec.dim), -1e5, np.float32)
    lab[..., 0], lab[..., 1] = 1.0, 0.0
    for i in range(2):
        lab[:, :, i, :7] = (0.0, 1.0, 0.0, 0.3 + 0.3 * i, 0.5, 0.8, 0.0)
        lab[:, :, i, spec.col_xs:] = rng.uniform(10, 110,
                                                 (b, t, spec.n_offsets))
    return lab


def leaf_names():
    return [n for n, _ in TorchPHNet(tp.torch_cfg(), device="cpu")
            .named_parameters()]


def torch_step(tcfg, variables, frames, labels, dtype=torch.float32):
    default = torch.get_default_dtype()
    torch.set_default_dtype(dtype)  # the memory ring and the constants too
    try:
        model = tp.torch_model(tcfg, variables).to(dtype)
        model.train()
        outs, mem = model.train_forward(torch.from_numpy(frames).to(dtype),
                                        torch.from_numpy(labels).to(dtype))
        loss, metrics = TorchCriterion(tcfg, tcfgmod.LossConfig())(
            outs, torch.from_numpy(labels).to(dtype))
        loss.backward()
    finally:
        torch.set_default_dtype(default)
    grads = {n: p.grad.double().numpy() for n, p in model.named_parameters()}
    return dict(outs=outs, mem=mem, loss=loss.item(), grads=grads,
                metrics={k: v.item() for k, v in metrics.items()},
                state=model.state_dict())


@pytest.fixture(scope="module")
def run():
    jcfg, tcfg = cfgs()
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(B, T, 64, 128, 3)).astype(np.float32)
    labels = clip_labels(rng, B, T, tcfg.lane)
    variables = tp.init_variables(jcfg, seed=0)
    model = JaxPHNet(jcfg)
    criterion = JaxCriterion(jcfg, jcfgmod.LossConfig())

    def loss_fn(params, batch_stats, f, lab):
        (outs, mem), updates = model.apply(
            {"params": params, "batch_stats": batch_stats}, f, lab,
            train=True, rngs={"dropout": jax.random.key(0)},
            mutable=["batch_stats"])
        loss, metrics = criterion(outs, lab)
        return loss, (outs, mem, updates, metrics)

    v = tp.jax_tree(variables)
    (loss, (outs, mem, updates, metrics)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], jnp.asarray(frames),
        jnp.asarray(labels))
    ref = dict(outs=outs, mem=mem, loss=float(loss),
               grad_norm=float(optax.global_norm(grads)),
               metrics={k: float(x) for k, x in metrics.items()},
               grads={k: g.numpy().astype(np.float64) for k, g in convert(
                   {"params": jax.tree_util.tree_map(np.asarray, grads)}
               ).items()},
               batch_stats={k: x.numpy() for k, x in convert(
                   {"batch_stats": jax.tree_util.tree_map(
                       np.asarray, updates["batch_stats"])}).items()})
    got = torch_step(tcfg, variables, frames, labels)
    return ref, got, (tcfg, variables, frames, labels)


def test_train_forward_matches(run):
    ref, got, _ = run
    o, r = got["outs"], ref["outs"]
    for name in ("matched_fir", "matched_sec"):
        np.testing.assert_array_equal(getattr(o, name).numpy(),
                                      np.asarray(getattr(r, name)),
                                      err_msg=name)
    for name in ("pred_fir", "pred_sec", "diff"):
        g, x = getattr(o, name).detach().numpy(), np.asarray(getattr(r, name))
        assert g.shape == x.shape, name
        np.testing.assert_allclose(g, x, rtol=0, atol=1e-3, err_msg=name)
    np.testing.assert_array_equal(got["mem"].mask.numpy(),
                                  np.asarray(ref["mem"].mask))
    np.testing.assert_allclose(got["mem"].values.detach().numpy(),
                               np.asarray(ref["mem"].values), rtol=0,
                               atol=1e-3)
    assert got["mem"].t == int(ref["mem"].t) == T


def test_loss_and_metrics_match(run):
    ref, got, _ = run
    assert abs(got["loss"] - ref["loss"]) <= 2e-5 * abs(ref["loss"])
    for k, x in ref["metrics"].items():
        assert abs(got["metrics"][k] - x) <= 2e-5 * abs(x) + 1e-6, k


def test_grad_norm_matches(run):
    ref, got, _ = run
    norm = np.sqrt(sum((g ** 2).sum() for g in got["grads"].values()))
    assert abs(norm - ref["grad_norm"]) <= 1e-4 * ref["grad_norm"]


@pytest.mark.parametrize("name", leaf_names())
def test_leaf_gradient_matches(run, name):
    ref, got, _ = run
    r, g = ref["grads"][name], got["grads"][name]
    assert g.shape == r.shape
    bound = leaf_tolerance(name) * np.abs(r).max() + 1e-5
    assert np.abs(g - r).max() <= bound, (np.abs(g - r).max(), bound)


def test_batchnorm_running_stats_after_step(run):
    """The running mean and biased variance after the step: 0.9 r + 0.1
    batch over both frames."""
    ref, got, _ = run
    assert ref["batch_stats"]
    for k, x in ref["batch_stats"].items():
        np.testing.assert_allclose(got["state"][k].numpy(), x, rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def exact(run):
    """The same port code in float64: the exact answer."""
    _, _, (tcfg, variables, frames, labels) = run
    return torch_step(tcfg, variables, frames, labels, torch.float64)


def test_port_float32_against_float64(run, exact):
    """Loss within 1e-5 relative of the float64 run, every gradient leaf
    within 2e-3 of its largest entry (plus 1e-6 for the leaves that are
    zero up to rounding)."""
    _, got, _ = run
    assert abs(got["loss"] - exact["loss"]) <= 1e-5 * abs(exact["loss"])
    for name, x in exact["grads"].items():
        bound = 2e-3 * np.abs(x).max() + 1e-6
        assert np.abs(got["grads"][name] - x).max() <= bound, name


def test_jax_float32_is_the_farther_from_float64(run, exact):
    """Where the bounds against JAX are wider than the port's own error,
    JAX's float32 result is the one off the exact answer: its loss is
    1.1e-5 relative from the float64 run (the port's 1.9e-6), and its
    gradient of the first router's chain parameters 1.5e-2 of their
    largest entry (the port's under 1e-4)."""
    ref, got, _ = run
    loss64 = abs(exact["loss"])
    assert abs(ref["loss"] - exact["loss"]) > 5e-6 * loss64
    assert abs(got["loss"] - exact["loss"]) < 5e-6 * loss64
    for name in ("head.routers.0.taps", "head.routers.0.ln_params"):
        x = exact["grads"][name]
        scale = np.abs(x).max()
        assert np.abs(ref["grads"][name] - x).max() > 5e-3 * scale, name
        assert np.abs(got["grads"][name] - x).max() < 1e-4 * scale, name
