"""The Bottleneck ResNet-50 (``BackboneConfig(depth=50)``) and the
GroupNorm ResNet (``norm="group"``) of the port against the JAX package
on the CPU, at the small configurations of ``torch_parity.BACKBONES``:
ResNet-50 at stage widths (8, 16, 24, 32), its stages giving (32, 64, 96,
128); the GroupNorm ResNet-18 at (32, 64, 96, 128), whose groups (32 of
them, ``min(32, C)``) hold 1 to 4 channels, 2 in the 64-wide stem; 64x128
frames. Also the configuration's checks, the JAX ``norm="batch_flax"``
tree loading as ``"batch"``, a training run's checkpoints of a RevCol
and a GroupNorm model, the trainer with RevCol, and the reference
importer's refusals.

Tolerances (measured in brackets; the port's own spread under a 1e-6
relative perturbation of the frames beside it):

* eval mode: the backbone's stages and the FPN levels within 2e-5 of the
  level's largest entry (ResNet-50 8e-7 relative; GroupNorm 5.9e-6 with
  an own spread of 5.7e-6: GroupNorm over groups of a few channels at 2x4
  positions amplifies the rounding);
* train mode (BatchNorm on the batch's statistics, GroupNorm as in eval
  mode): the stages within 2e-5 of their largest entry plus JAX's own
  float32 error, |JAX - the port's float64 backbone| (the port's float64
  step is held to JAX's float64 step in ``test_torch_train_r50.py``):
  BatchNorm over 2x4 positions of 6 images amplifies float32 rounding,
  and JAX's last ResNet-50 stage is 4.1e-4 of its largest entry from the
  float64 one where the port's is 7.2e-5; the running statistics within
  1e-5 plus JAX's own float32 error, measured the same way;
* the clip's kept rows and memory within 1e-4, keeps and masks equal;
* bf16 (the ``exact_jit`` oracle of ``test_torch_bf16.py``): the FPN
  levels are bf16 values within twice the port's own one-ulp spread
  (ResNet-50 0.032 against an own spread of 0.039; GroupNorm 0.125
  against 0.166): one-ulp differences from summation order grow through
  16 Bottlenecks and through small groups.

The f32 training steps against the JAX package are in
``test_torch_train_r50.py`` and ``test_torch_train_gn.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phnet_torch.config as tcfg
import phnet_tpu.config as jcfg
from phnet_torch.convert import convert, plan
from phnet_torch.data import ClipLoader, SyntheticVideoDataset
from phnet_torch.models import PHNet as TorchPHNet
from phnet_torch.models.phnet import init_memory as torch_init_memory
from phnet_torch.train.checkpoint import CheckpointManager
from phnet_torch.train.state import create_train_state
from phnet_torch.train.trainer import train
from phnet_torch.utils import torch_import as t_imp
from phnet_tpu.models import PHNet as JaxPHNet
from phnet_tpu.models.phnet import init_memory as jax_init_memory
from phnet_tpu.models.resnet import ResNetBackbone as JaxResNet

import torch_parity as tp
from test_torch_bf16 import exact_jit, one_ulp

B, T, WINDOW = 2, 3, 4
LEVEL_REL = 2e-5        # of max |level|
STATS_ATOL = 1e-5
ATOL = 1e-4
BACKBONES = ["r50", "gn"]


def cfgs(backbone, **kw):
    return tuple(dataclasses.replace(
        tp.small_backbone_cfg(m, backbone), **kw) for m in (jcfg, tcfg))


@pytest.fixture(scope="module", params=BACKBONES)
def setup(request):
    jc, tc = cfgs(request.param)
    variables = tp.init_variables(jc, seed=0)
    return jc, tc, variables, tp.torch_model(tc, variables)


@pytest.fixture(scope="module")
def frames():
    return tp.seeded_frames(1, (B, T, 64, 128, 3))


# -- configuration ----------------------------------------------------------

@pytest.mark.parametrize("bad", [dict(kind="swin"), dict(depth=101),
                                 dict(norm="batch_flax"), dict(norm="layer"),
                                 dict(in_channels=(8, 16, 24)),
                                 dict(kind="revcol", revcol_layers=(1, 1))])
def test_config_rejects_what_does_not_build(bad):
    with pytest.raises(ValueError):
        tcfg.BackboneConfig(**bad)


@pytest.mark.parametrize("fields", [dict(depth=50), dict(norm="group"),
                                    dict(depth=34, norm="group"),
                                    dict(kind="revcol")])
def test_config_fields_are_the_jax_package_s(fields):
    tp.check_fields(tcfg.BackboneConfig(**fields),
                    jcfg.BackboneConfig(**fields), "backbone")


@pytest.mark.parametrize("backbone", [
    dict(depth=50), dict(norm="group"), dict(depth=50, norm="group")])
def test_full_width_tree_loads_strictly(backbone):
    """The JAX tree of ``vil100_config`` with the backbone (ResNet-50's
    neck taking (512, 1024, 2048)) maps key for key and shape for shape
    onto the port's model; a GroupNorm tree has no ``batch_stats``."""
    neck = {}
    if backbone.get("depth") == 50:
        neck = dict(in_channels=(512, 1024, 2048))
    models = []
    for m in (jcfg, tcfg):
        base = m.vil100_config().model
        models.append(dataclasses.replace(
            base, backbone=m.BackboneConfig(**backbone),
            neck=dataclasses.replace(base.neck, **neck)))
    shapes = tp.variable_shapes(models[0])
    assert ("batch_stats" in shapes) == (backbone.get("norm") != "group")
    got = {k: s for k, (_, s) in plan(shapes).items()}
    model = TorchPHNet(models[1], device="cpu")
    assert got == {k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_batch_flax_tree_loads_as_batch(frames):
    """A tree of the JAX ``norm="batch_flax"`` backbone (flax's own
    BatchNorm, the same names and function) loads strictly into the
    port's ``norm="batch"`` model and gives the JAX model's levels."""
    jc = dataclasses.replace(tp.jax_cfg(), backbone=jcfg.BackboneConfig(
        in_channels=(8, 16, 24, 32), norm="batch_flax"))
    variables = tp.init_variables(jc, seed=4)
    tm = tp.torch_model(tp.torch_cfg(), variables)  # strict
    jm = JaxPHNet(jc)
    ref = jax.jit(lambda v, f: jm.apply(v, f, method=jm.encode))(
        tp.jax_tree(variables), jnp.asarray(frames))
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(frames))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(tp.to_np(g), r, rtol=0,
                                   atol=LEVEL_REL * np.abs(r).max())


# -- the two backbones against JAX ----------------------------------------

def jax_backbone(jc, variables, x, train):
    """The JAX backbone's four stages (NHWC) and, in train mode, its
    updated running statistics by the port's key."""
    b = jc.backbone
    jm = JaxResNet(depth=b.depth, stage_channels=b.in_channels,
                   norm=b.norm, stem="conv7")
    tree = tp.jax_tree(variables)
    v = {"params": tree["params"]["encoder"]["backbone"]}
    if "batch_stats" in tree:
        v["batch_stats"] = tree["batch_stats"]["encoder"]["backbone"]
    outs, updates = jax.jit(lambda v, f: jm.apply(
        v, f, train=train, mutable=["batch_stats"]))(v, jnp.asarray(x))
    stats = dict(updates).get("batch_stats", {})
    stats = convert({"batch_stats": {"encoder": {"backbone": jax.tree_util
                                                 .tree_map(np.asarray,
                                                           stats)}}})
    return [np.asarray(o) for o in outs], stats


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_backbone_stages_match_jax(setup, frames, train):
    """The four stages in eval mode and in train mode (BatchNorm on the
    batch's statistics, which then update the running ones)."""
    jc, tc, variables, _ = setup
    x = frames.reshape((-1,) + frames.shape[2:])
    ref, ref_stats = jax_backbone(jc, variables, x, train)
    runs, sds = {}, {}
    for dtype in (torch.float32, torch.float64):
        tm = tp.torch_model(tc, variables).to(dtype)
        tm.train(train)
        with torch.no_grad():
            runs[dtype] = [tp.to_np(o.permute(0, 2, 3, 1)) for o in
                           tm.encoder.backbone(torch.from_numpy(x).to(
                               dtype).permute(0, 3, 1, 2))]
        sds[dtype] = tm.state_dict()
    sd, exact = sds[torch.float32], sds[torch.float64]
    widths = [4 * c if jc.backbone.depth == 50 else c
              for c in jc.backbone.in_channels]
    assert [r.shape[-1] for r in ref] == widths
    for g, r, f64 in zip(runs[torch.float32], ref, runs[torch.float64]):
        jax_error = np.abs(r - f64).max() if train else 0.0
        np.testing.assert_allclose(
            g, r, rtol=0, atol=LEVEL_REL * np.abs(r).max() + jax_error)
    assert set(ref_stats) == {k for k in sd if k.startswith(
        "encoder.backbone.") and k.split(".")[-1] in ("mean", "var")}
    assert bool(ref_stats) == (jc.backbone.norm == "batch")
    for k, r in ref_stats.items():
        jax_error = (r.double() - exact[k]).abs().max().item()
        np.testing.assert_allclose(sd[k].numpy(), r.numpy(), rtol=0,
                                   atol=STATS_ATOL + jax_error, err_msg=k)


def test_encoder_levels_match_jax(setup, frames):
    jc, _, variables, tm = setup
    jm = JaxPHNet(jc)
    ref = jax.jit(lambda v, f: jm.apply(v, f, method=jm.encode))(
        tp.jax_tree(variables), jnp.asarray(frames))
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(frames))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(tp.to_np(g), r, rtol=0,
                                   atol=LEVEL_REL * np.abs(r).max())


def test_clip_frame_by_frame(setup, frames):
    """The clip one frame at a time through a 4-frame ring: keeps and
    masks equal, kept rows and memory within ``ATOL``; lanes kept."""
    jc, _, variables, tm = setup
    jm = JaxPHNet(jc)
    step = jax.jit(lambda v, f, mem: jm.apply(v, f, None, train=False,
                                              initial_memory=mem))
    jv = tp.jax_tree(variables)
    jmem = jax_init_memory(jc, B, WINDOW)
    tmem = torch_init_memory(tm.cfg, B, WINDOW)
    kept = 0
    for t in range(T):
        jout, jmem = step(jv, jnp.asarray(frames[:, t:t + 1]), jmem)
        tout, tmem = tm(torch.from_numpy(frames[:, t:t + 1]),
                        initial_memory=tmem)
        np.testing.assert_array_equal(tp.to_np(tout.num_kept),
                                      np.asarray(jout.num_kept))
        np.testing.assert_array_equal(tp.to_np(tout.kept_valid),
                                      np.asarray(jout.kept_valid))
        np.testing.assert_allclose(tp.to_np(tout.kept),
                                   np.asarray(jout.kept), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(tp.to_np(tmem.mask),
                                      np.asarray(jmem.mask))
        np.testing.assert_allclose(tp.to_np(tmem.values),
                                   np.asarray(jmem.values), rtol=0,
                                   atol=ATOL)
        kept += int(tout.num_kept.sum())
    assert kept > 0


def test_bf16_encoder_matches_exact_oracle(setup, frames):
    """bf16: the FPN levels are bf16 values within twice the port's own
    one-ulp spread of JAX's."""
    jc, tc, variables, _ = setup
    jc, tc = (dataclasses.replace(c, compute_dtype="bfloat16")
              for c in (jc, tc))
    jm = JaxPHNet(jc)
    ref = exact_jit(lambda v, f: jm.apply(v, f, method=jm.encode))(
        tp.jax_tree(variables), jnp.asarray(frames))
    tm = tp.torch_model(tc, variables)
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(frames))
        own = tm.encode(torch.from_numpy(one_ulp(frames)))
    for g, r, o in zip(got, ref, own):
        g, r, o = tp.to_np(g), np.asarray(r), tp.to_np(o)
        np.testing.assert_array_equal(
            g, torch.from_numpy(g).bfloat16().float().numpy())
        assert np.abs(g - r).max() <= 2 * np.abs(o - g).max()


# -- checkpoints and the reference importer ------------------------------

@pytest.mark.parametrize("backbone", ["revcol", "gn"])
def test_checkpoints_restore(tmp_path, backbone):
    """``restore_state`` and ``restore_weights`` on a RevCol model (no
    ``conv0``) and a GroupNorm one (no BatchNorm statistics): the saved
    weights, step, optimizer state, epoch and ``max_skip`` come back."""
    tc = tp.small_backbone_cfg(tcfg, backbone)
    cfg = tcfg.Config(model=tc)
    state = create_train_state(cfg, 10, "cpu", seed=0)
    state.step = 3
    for p in state.model.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(state, epoch=2, max_skip=10, is_best=True)
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    fresh, epoch, max_skip = ckpt.restore_state(
        create_train_state(cfg, 10, "cpu", seed=1))
    assert (fresh.step, epoch, max_skip, fresh.optimizer.count) == (
        3, 2, 10, 1)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    weights = ckpt.restore_weights(create_train_state(cfg, 10, "cpu",
                                                      seed=2))
    assert weights.step == 0
    for k, v in weights.model.state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_trainer_trains_and_resumes_revcol(tmp_path):
    """``train()`` (unchanged) with RevCol, drop path 0.1 and its column
    checkpoint: an epoch of 2 steps, then resumed for a second; finite
    losses, the resumed step. (The other backbones' steps and checkpoints
    are held above and in the training-step files.)"""
    m = tp.small_backbone_cfg(tcfg, "revcol", revcol_drop_path=0.1)
    cfg = tcfg.Config(model=m, train=tcfg.TrainConfig(epoch_per_test=1))

    def data():
        ds = SyntheticVideoDataset(n_videos=2, frames_per_video=2,
                                   img_h=m.img_h, img_w=m.img_w,
                                   spec=m.lane, max_lanes=m.max_lanes)
        return ds, ClipLoader(ds, batch_size=1, seed=0)

    ds, loader = data()
    state, hist = train(cfg, ds, loader, str(tmp_path), epochs=1,
                        device="cpu", verbose=False)
    assert state.step == 2 and np.isfinite(hist).all()
    ds2, loader2 = data()
    state2, hist2 = train(cfg, ds2, loader2, str(tmp_path), epochs=2,
                          resume=True, device="cpu", verbose=False)
    assert state2.step == 4 and np.isfinite(hist2).all()


@pytest.mark.parametrize("backbone", ["revcol", "r50"])
def test_importer_refuses_other_backbones(backbone):
    """The reference importer reads BasicBlock ResNets only (so does the
    JAX package's): a RevCol or Bottleneck target raises, by both
    entries, before any key is read."""
    target = TorchPHNet(tp.small_backbone_cfg(tcfg, backbone),
                        device="cpu").state_dict()
    with pytest.raises(ValueError, match="BasicBlock"):
        t_imp.import_reference_checkpoint({}, target)
    with pytest.raises(ValueError, match="BasicBlock"):
        t_imp.load_pretrained_backbone(target, {})
