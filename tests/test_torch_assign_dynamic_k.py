"""The dynamic-k (SimOTA) training assigner of the port
(``phnet_torch.losses.assign``) against the JAX package's, bit-equal, on
the CPU: ``dynamic_k_assign`` on seeded costs and IoUs with exact ties
(integer costs, IoUs in eighths), invalid targets, and small prior counts
(4 up) where later targets take priors already taken and a target is left
with none; ``dynamic_k_frame`` (batched here, one frame at a time there) on
seeded predictions and labels, including targets stripped of every prior
(the global-minimum fallback); and ``train_assign``'s dispatch on
``ModelConfig.train_assigner``. The training step under this assigner is
``test_torch_train_dynamic_k.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phnet_torch.config as tcfgmod
import phnet_tpu.config as jcfgmod
from phnet_torch.losses import assign as port
from phnet_tpu.losses import assign as ref


# (priors, targets): fewer priors than the targets' k's, the presets'
# target counts, one target
SHAPES = ((4, 3), (5, 8), (7, 4), (29, 8), (12, 1))


def problem(rng, a, l, ties):
    if ties:
        cost = rng.integers(-4, 4, (a, l)).astype(np.float32)
        iou = (rng.integers(-1, 9, (a, l)) / 8).astype(np.float32)
    else:
        cost = rng.normal(size=(a, l)).astype(np.float32)
        iou = rng.uniform(-0.2, 1.0, (a, l)).astype(np.float32)
    valid = rng.random(l) < 0.75
    return cost, iou, valid


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "distinct"])
def test_dynamic_k_assign_bit_equal(ties):
    rng = np.random.default_rng(3)
    stripped = 0
    jax_assign = jax.jit(ref.dynamic_k_assign)  # one compile a shape
    for trial in range(150):
        a, l = SHAPES[trial % len(SHAPES)]
        cost, iou, valid = problem(rng, a, l, ties)
        want = np.asarray(jax_assign(
            jnp.asarray(cost), jnp.asarray(iou), jnp.asarray(valid)))
        got = port.dynamic_k_assign(torch.from_numpy(cost),
                                    torch.from_numpy(iou),
                                    torch.from_numpy(valid))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
        stripped += int((valid & ~want.any(0)).any())
    assert stripped > 0  # some valid target lost all its priors


def test_dynamic_k_assign_batched_equals_per_problem():
    rng = np.random.default_rng(4)
    cost, iou, valid = zip(*[problem(rng, 12, 5, True) for _ in range(6)])
    cost, iou, valid = (torch.from_numpy(np.stack(x).reshape(
        2, 3, *x[0].shape)) for x in (cost, iou, valid))
    got = port.dynamic_k_assign(cost, iou, valid)
    for i in range(2):
        for j in range(3):
            np.testing.assert_array_equal(
                got[i, j].numpy(), port.dynamic_k_assign(
                    cost[i, j], iou[i, j], valid[i, j]).numpy())


def frame_problem(rng, spec, a, l, img_w, img_h, cluster):
    """Predictions [A, dim] (normalized xs) and targets [L, dim] (pixel
    xs, label layout); ``cluster`` puts every prior near one target so
    that the others are stripped."""
    pred = np.zeros((a, spec.dim), np.float32)
    pred[:, :2] = rng.normal(size=(a, 2))
    pred[:, spec.col_start_y] = rng.uniform(0, 1, a)
    pred[:, spec.col_start_x] = rng.uniform(0, 1, a)
    pred[:, spec.col_theta] = rng.uniform(0, 1, a)
    pred[:, spec.col_length] = rng.uniform(0, 1, a)
    tgt = np.full((l, spec.dim), -1e5, np.float32)
    tgt[:, 0], tgt[:, 1] = 0.0, 1.0
    tgt[:, spec.col_start_y] = rng.uniform(0, 1, l)
    tgt[:, spec.col_start_x] = rng.uniform(0, 1, l)
    tgt[:, spec.col_theta] = rng.uniform(0, 1, l)
    tgt[:, spec.col_length] = rng.uniform(0.2, 1, l) * spec.n_strips
    centers = rng.uniform(0.1 * img_w, 0.9 * img_w, l)
    for i in range(l):
        n = int(rng.integers(spec.n_offsets // 2, spec.n_offsets + 1))
        tgt[i, spec.col_xs + spec.n_offsets - n:] = centers[i] + rng.normal(
            0, 5, n)
    base = np.resize(centers[:1] if cluster else centers, a)
    pred[:, spec.col_xs:] = ((base[:, None] + rng.normal(
        0, 8, (a, spec.n_offsets))) / (img_w - 1))
    valid = rng.random(l) < 0.8
    valid[0] = True
    return pred, tgt, valid


@pytest.mark.parametrize("preset", ["vil100_config", "openlane_config"])
def test_dynamic_k_frame_bit_equal(preset):
    tc = getattr(tcfgmod, preset)().model
    jc = getattr(jcfgmod, preset)().model
    rng = np.random.default_rng(5)
    l = tc.max_lanes

    def frame_and_match(p, t, v):
        cost, iou = ref._cost_and_iou(p, t, v, jc.lane, 128, 64)
        return (ref.dynamic_k_frame(p, t, v, jc.lane, 128, 64),
                ref.dynamic_k_assign(cost, iou, v))

    jax_frames = jax.jit(jax.vmap(frame_and_match))
    stripped = 0
    for b in range(12):
        a = (4, 6, 24)[b % 3]  # fewer priors than the targets' k's too
        batch = [frame_problem(rng, tc.lane, a, l, 128, 64, b % 2 == 0)
                 for _ in range(3)]
        pred, tgt, valid = (np.stack(x) for x in zip(*batch))
        got = port.dynamic_k_frame(torch.from_numpy(pred),
                                   torch.from_numpy(tgt),
                                   torch.from_numpy(valid), tc.lane, 128, 64)
        assert got.dtype == torch.int64 and got.shape == (3, l)
        want, match = (np.asarray(x) for x in jax_frames(
            jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(valid)))
        np.testing.assert_array_equal(got.numpy(), want)
        stripped += int((valid & ~match.any(1)).any())
    assert stripped > 0  # the fallback ran


def test_train_assign_dispatches_on_the_config():
    tc = tcfgmod.vil100_config().model
    rng = np.random.default_rng(6)
    pred, tgt, valid = (torch.from_numpy(x) for x in frame_problem(
        rng, tc.lane, 40, tc.max_lanes, tc.img_w, tc.img_h, False))
    dk = tcfgmod.ModelConfig(train_assigner="dynamic_k", lane=tc.lane,
                             img_h=tc.img_h, img_w=tc.img_w)
    np.testing.assert_array_equal(
        port.train_assign(dk, pred, tgt, valid).numpy(),
        port.dynamic_k_frame(pred, tgt, valid, tc.lane, tc.img_w,
                             tc.img_h).numpy())
    np.testing.assert_array_equal(
        port.train_assign(tc, pred, tgt, valid).numpy(),
        port.assign_frame(pred, tgt, valid, tc.lane, tc.img_w,
                          tc.img_h).numpy())
