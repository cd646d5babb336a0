"""The port's assignment cost, Hungarian match, focal loss, line IoUs and
criterion against the JAX package at the small configuration's lane
layout (32 priors, 12 offsets, 4 label rows, 3 stages), as values and as
gradients. The JAX side is vmapped over the frames the port batches.

Tolerances: values 1e-5 relative (float32, the same formulas; the sums
run in another order); gradients 1e-5 of the largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phnet_torch.config as tcfgmod
import phnet_tpu.config as jcfgmod
import torch_parity as tp
from phnet_torch.losses import assign as tassign
from phnet_torch.losses.criterion import LaneCriterion as TorchCriterion
from phnet_torch.losses.focal import softmax_focal_loss
from phnet_torch.models.phnet import TrainFrameOut as TorchOut
from phnet_tpu.losses import assign as jassign
from phnet_tpu.losses.criterion import LaneCriterion as JaxCriterion
from phnet_tpu.losses.focal import softmax_focal_loss as jax_focal
from phnet_tpu.models.phnet import TrainFrameOut as JaxOut

S, N, A, L = 3, 6, 32, 4
RTOL = 1e-5


def make_labels(rng, n, spec, lanes=2):
    """n frames of ``lanes`` valid lanes (pixel xs in a 128-wide image;
    the last rows padded as the label encoder pads them)."""
    lab = np.full((n, L, spec.dim), -1e5, np.float32)
    lab[..., 0], lab[..., 1] = 1.0, 0.0
    for i in range(lanes):
        lab[:, i, :7] = (0.0, 1.0, 0.0, 0.25 + 0.3 * i, 0.5, 0.7, 0.1)
        lab[:, i, 2] = rng.uniform(0.0, 0.3, n)
        lab[:, i, spec.col_xs:] = rng.uniform(5, 120, (n, spec.n_offsets))
        lab[:, i, -3:] = -1e5  # rows past the lane's top
    lab[0, :, :2] = (1.0, 0.0)  # frame 0 has no lane at all
    return lab


def make_preds(rng, lead, spec):
    """Predictions in the head's layout: cls logits, start_y / start_x /
    theta in (0, 1), two lengths, xs normalized by the image width."""
    p = np.empty(lead + (A, spec.dim), np.float32)
    p[..., :2] = rng.normal(0, 2, lead + (A, 2))
    p[..., 2:5] = rng.uniform(0.05, 0.95, lead + (A, 3))
    p[..., 5:7] = rng.uniform(0, 1, lead + (A, 2))
    p[..., spec.col_xs:] = rng.uniform(-0.1, 1.1, lead + (A, spec.n_offsets))
    return p


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tp.jax_cfg(), tp.torch_cfg()
    rng = np.random.default_rng(0)
    labels = make_labels(rng, N, tcfg.lane)
    preds = make_preds(rng, (2, S, N), tcfg.lane)
    diff = rng.uniform(0.5, 1.0, (S, N, A)).astype(np.float32)
    return jcfg, tcfg, labels, preds, diff


def jax_assign_all(jcfg, preds, labels):
    """JAX matches [..., N, L] for predictions [..., N, A, dim]."""
    valid = jnp.asarray(labels[..., 1] == 1.0)
    one = lambda p, l, v: jassign.assign_frame(  # noqa: E731
        p, l, v, jcfg.lane, jcfg.img_w, jcfg.img_h)
    fn = jax.vmap(one)
    for _ in range(preds.ndim - 3):
        fn = jax.vmap(fn, in_axes=(0, None, None))
    return np.asarray(jax.jit(fn)(jnp.asarray(preds), jnp.asarray(labels),
                                  valid))


def test_assignment_cost_and_match(setup):
    jcfg, tcfg, labels, preds, _ = setup
    p = preds[1, 0]  # [N, A, dim]
    valid = labels[..., 1] == 1.0
    ref = jax.jit(jax.vmap(lambda a, b, c: jassign.assignment_cost(
        a, b, c, jcfg.lane, jcfg.img_w, jcfg.img_h)))(
        jnp.asarray(p), jnp.asarray(labels), jnp.asarray(valid))
    got = tassign.assignment_cost(torch.from_numpy(p),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(valid), tcfg.lane,
                                  tcfg.img_w, tcfg.img_h)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (N, L, A)
    rows = np.broadcast_to(valid[..., None], ref.shape)
    np.testing.assert_allclose(got.numpy()[rows], ref[rows], rtol=RTOL,
                               atol=RTOL * np.abs(ref[rows]).max())
    matched = tassign.assign_frame(
        torch.from_numpy(preds), torch.from_numpy(labels),
        torch.from_numpy(valid), tcfg.lane, tcfg.img_w, tcfg.img_h)
    np.testing.assert_array_equal(matched.numpy(),
                                  jax_assign_all(jcfg, preds, labels))


@pytest.mark.parametrize("alpha", [(0.5, 0.5), (0.1, 0.9)])
def test_focal_loss_value_and_grad(alpha):
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (N, A, 2)).astype(np.float32)
    target = rng.integers(0, 2, (N, A))
    jf = lambda x: jax_focal(x, jnp.asarray(target), alpha, 2.0)  # noqa
    ref, ref_g = jax.value_and_grad(lambda x: (jf(x) * 1.5).sum())(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = softmax_focal_loss(x, torch.from_numpy(target), alpha, 2.0)
    (got * 1.5).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jf(
        jnp.asarray(logits))), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_g), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(ref_g)).max())
    assert abs(float(got.sum() * 1.5) - float(ref)) <= RTOL * abs(float(ref))


@pytest.mark.parametrize("which", ["line_pairwise", "line_aligned",
                                   "lane_aligned"])
def test_line_ious(which):
    rng = np.random.default_rng(2)
    pred = rng.uniform(0, 128, (N, A, 12)).astype(np.float32)
    tgt = rng.uniform(-20, 140, (N, A, 12)).astype(np.float32)
    tgt[:, :, -3:] = -1e5
    if which == "line_pairwise":
        tgt = tgt[:, :L]
        jfn = jax.vmap(lambda p, t: jassign.line_iou_pairwise(p, t, 128))
        tfn = lambda p, t: tassign.line_iou_pairwise(p, t, 128)  # noqa
    elif which == "line_aligned":
        jfn = lambda p, t: jassign.line_iou_aligned(p, t, 128)  # noqa
        tfn = lambda p, t: tassign.line_iou_aligned(p, t, 128)  # noqa
    else:
        pred, tgt = pred / 128, tgt / 128
        jfn = lambda p, t: jassign.lane_iou_aligned(p, t, 400, 960)  # noqa
        tfn = lambda p, t: tassign.lane_iou_aligned(p, t, 400, 960)  # noqa
    w = rng.normal(size=jfn(jnp.asarray(pred), jnp.asarray(tgt)).shape)
    ref, ref_g = jax.value_and_grad(
        lambda p: (jfn(p, jnp.asarray(tgt)) * w).sum())(jnp.asarray(pred))
    x = torch.from_numpy(pred).requires_grad_()
    got = tfn(x, torch.from_numpy(tgt))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(jfn(jnp.asarray(pred),
                                             jnp.asarray(tgt))),
        rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_g), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(ref_g)).max())


def criteria(jcfg, tcfg, style):
    jl = jcfgmod.LossConfig(style=style, use_lane_iou=style == "blend_cls")
    tl = tcfgmod.LossConfig(style=style, use_lane_iou=style == "blend_cls")
    return JaxCriterion(jcfg, jl), TorchCriterion(tcfg, tl)


@pytest.mark.parametrize("matched", ["given", "solved"])
@pytest.mark.parametrize("style", ["blend_all", "blend_cls"])
def test_frame_loss_value_and_grads(setup, style, matched):
    """frame_loss of N frames: loss and metrics, and the gradients into
    both branches' predictions and the router scores."""
    jcfg, tcfg, labels, preds, diff = setup
    jc, tc = criteria(jcfg, tcfg, style)
    m = jax_assign_all(jcfg, preds, labels)  # [2, S, N, L]
    m_args = (m[1], m[0]) if matched == "given" else (None, None)

    def jloss(pf, ps, d):
        def one(pf1, ps1, d1, lab, ms, mf):
            return jc.frame_loss(pf1, ps1, d1, lab, ms, mf)
        axes = (1, 1, 1, 0) + ((1, 1) if matched == "given" else (None,
                                                                   None))
        return jax.vmap(one, in_axes=axes)(pf, ps, d, jnp.asarray(labels),
                                           *m_args)

    (ref, ref_m), ref_g = jax.value_and_grad(
        lambda *a: (jloss(*a)[0].sum(), jloss(*a)[1]), argnums=(0, 1, 2),
        has_aux=True)(jnp.asarray(preds[0]), jnp.asarray(preds[1]),
                      jnp.asarray(diff))
    xs = [torch.from_numpy(a.copy()).requires_grad_()
          for a in (preds[0], preds[1], diff)]
    t_m = ((torch.from_numpy(m[1]), torch.from_numpy(m[0]))
           if matched == "given" else (None, None))
    got, got_m = tc.frame_loss(*xs, torch.from_numpy(labels), *t_m)
    got.sum().backward()
    assert abs(float(got.sum()) - float(ref)) <= RTOL * abs(float(ref))
    for k in ("cls", "reg", "iou"):
        np.testing.assert_allclose(got_m[k].detach().numpy(),
                                   np.asarray(ref_m[k]), rtol=RTOL,
                                   atol=1e-6, err_msg=k)
    for x, r, name in zip(xs, ref_g, ("pred_fir", "pred_sec", "diff")):
        r = np.asarray(r)
        np.testing.assert_allclose(x.grad.numpy(), r, rtol=RTOL,
                                   atol=RTOL * np.abs(r).max(), err_msg=name)


def test_clip_loss_with_precomputed_matches(setup):
    """The clip loss of TrainFrameOut-shaped outputs [T, S, B, ...] with the
    model's matches, against the JAX criterion's ``__call__``."""
    jcfg, tcfg, labels, preds, diff = setup
    jc, tc = criteria(jcfg, tcfg, "blend_all")
    t, b = 3, 2  # N = 6 frames as 3 frames of 2 streams
    m = jax_assign_all(jcfg, preds, labels)  # [2, S, N, L]

    def tsb(x):  # [S, N, ...] -> [T, S, B, ...] (frame n = t * B + b)
        x = x.reshape((x.shape[0], t, b) + x.shape[2:])
        return np.ascontiguousarray(np.swapaxes(x, 0, 1))

    lab_bt = np.swapaxes(labels.reshape((t, b) + labels.shape[1:]), 0, 1)
    parts = [tsb(preds[0]), tsb(preds[1]), tsb(diff), tsb(m[1]), tsb(m[0])]
    ref, ref_m = jc(JaxOut(*map(jnp.asarray, parts)), jnp.asarray(lab_bt))
    got, got_m = tc(TorchOut(*map(torch.from_numpy, parts)),
                    torch.from_numpy(np.ascontiguousarray(lab_bt)))
    assert abs(float(got) - float(ref)) <= RTOL * abs(float(ref))
    for k in ref_m:
        assert abs(float(got_m[k]) - float(ref_m[k])) <= RTOL * abs(
            float(ref_m[k])) + 1e-6, k


def test_criterion_configs_match():
    """The port's LossConfig keeps the JAX package's defaults."""
    j, t = jcfgmod.LossConfig(), tcfgmod.LossConfig()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert tcfgmod.vil100_config().train.loss == tcfgmod.LossConfig()
