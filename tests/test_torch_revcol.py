"""RevCol (``BackboneConfig(kind="revcol")``, the reference's
``revcolV2.py``) in the port against the JAX package on the CPU, at the
small configuration of ``torch_parity.BACKBONES["revcol"]``: widths (8,
16, 24, 32), layers (1, 1, 2, 1), 3 columns, 64x128 frames, drop path 0
where the packages are compared. The weights come from
``torch_parity.init_variables``, which draws RevCol's ``gamma`` from N(0,
0.5) and its ``alpha`` from U(-1, 1) with 0 and +-5e-4 in every leaf (the
JAX init's 1e-6 and 0.5 would hide an error in a block, and the clamp).

Tolerances (measured in brackets; the port's own spread under a 1e-6
relative perturbation of the frames beside it):

* the backbone's levels and the FPN levels within 2e-5 of the level's
  largest entry (port against JAX 5.7e-7 relative; own spread 1.5e-6);
* the clip's kept rows and memory, and the server's, within 1e-4, keeps
  and masks equal;
* bf16: the JAX oracle compiled without excess precision (``exact_jit``
  of ``test_torch_bf16.py``); RevCol computes in float32 from the frames
  rounded to bf16 and the FPN in bf16, so the levels are bf16 values, at
  least 97% of them bit-equal to JAX's (98.9% on the finest level, all
  of the others), the rest within twice the port's own one-ulp spread.
  Had the neck stayed in float32 on RevCol's float32 levels, none would
  be bf16 values.

The f32 training step against the JAX package is in
``test_torch_train_revcol.py``.
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
from phnet_torch.losses.criterion import LaneCriterion as TorchCriterion
from phnet_torch.models import PHNet as TorchPHNet
from phnet_torch.models.phnet import init_memory as torch_init_memory
from phnet_torch.serving import StreamingServer as TorchServer
from phnet_torch.train.optimizer import Optimizer, revcol_layer_scales
from phnet_torch.train.state import create_train_state
from phnet_tpu.models import PHNet as JaxPHNet
from phnet_tpu.models.phnet import init_memory as jax_init_memory
from phnet_tpu.models.revcol import RevColBackbone as JaxRevCol
from phnet_tpu.serving import StreamingServer as JaxServer
from phnet_tpu.train.optimizer import \
    revcol_layer_scales as jax_revcol_layer_scales

import torch_parity as tp
import torch_train_parity as ttp
from test_torch_bf16 import exact_jit, one_ulp

B, T, WINDOW = 2, 3, 4
LEVEL_REL = 2e-5   # of max |level|
ATOL = 1e-4        # kept rows and memory
BF16_EQUAL = 0.97  # share of bf16 FPN entries bit-equal to JAX's


def cfgs(**kw):
    """(JAX, port) small RevCol ModelConfigs, ``kw`` on their model."""
    return tuple(dataclasses.replace(
        tp.small_backbone_cfg(m, "revcol"), **kw) for m in (jcfg, tcfg))


@pytest.fixture(scope="module")
def setup():
    jc, tc = cfgs()
    variables = tp.init_variables(jc, seed=0)
    return jc, tc, variables, tp.torch_model(tc, variables)


@pytest.fixture(scope="module")
def frames():
    return tp.seeded_frames(1, (B, T, 64, 128, 3))


def test_config_is_the_jax_package_s():
    """The port's RevCol fields and defaults are the JAX package's
    (revcol_tiny)."""
    got = tcfg.BackboneConfig(kind="revcol")
    ref = jcfg.BackboneConfig(kind="revcol")
    tp.check_fields(got, ref, "backbone")
    assert (got.revcol_layers, got.revcol_num_subnet, got.revcol_drop_path,
            got.revcol_save_memory) == ((2, 2, 4, 2), 4, 0.1, True)


def test_full_width_tree_loads_strictly():
    """The JAX tree of ``vil100_config`` with the default RevCol maps key
    for key and shape for shape onto the port's model (what a strict
    ``load_state_dict`` needs)."""
    rev = dict(backbone=jcfg.BackboneConfig(kind="revcol"))
    jc = dataclasses.replace(jcfg.vil100_config().model, **rev)
    tc = dataclasses.replace(tcfg.vil100_config().model, backbone=(
        tcfg.BackboneConfig(kind="revcol")))
    shapes = {k: s for k, (_, s) in plan(tp.variable_shapes(jc)).items()}
    model = TorchPHNet(tc, device="cpu")
    assert shapes == {k: tuple(v.shape)
                      for k, v in model.state_dict().items()}
    assert sum(k.startswith("encoder.backbone.subnet3.") for k in shapes)


def test_small_tree_loads_strictly(setup):
    """Every leaf of the small tree, values included (``torch_model``
    loads strictly): the depthwise kernels [3, 3, 1, C] as [C, 1, 3,
    3]."""
    _, _, variables, tm = setup
    dw = variables["params"]["encoder"]["backbone"]["subnet1"]["level2"][
        "block0"]["dwconv"]["kernel"]
    got = tm.encoder.backbone.subnet1.level2.block0.dwconv.weight
    assert dw.shape == (3, 3, 1, 24) and tuple(got.shape) == (24, 1, 3, 3)
    np.testing.assert_array_equal(got.detach().numpy()[:, 0],
                                  dw[:, :, 0].transpose(2, 0, 1))


def test_alpha_is_clamped_at_use(setup):
    """``sign(a) * max(|a|, 1e-3)``: 0 stays 0, +-5e-4 become +-1e-3, the
    rest pass; the first column has no alpha."""
    _, _, _, tm = setup
    sub = tm.encoder.backbone.subnet2
    raw = sub.alpha0.detach()
    assert raw[:3].tolist() == pytest.approx([0.0, -5e-4, 5e-4])
    np.testing.assert_array_equal(
        sub.alpha(0).detach().numpy(),
        np.asarray(jnp.sign(raw.numpy()) * jnp.maximum(
            jnp.abs(raw.numpy()), 1e-3)))
    assert sub.alpha(0)[:3].tolist() == pytest.approx([0.0, -1e-3, 1e-3])
    assert not hasattr(tm.encoder.backbone.subnet0, "alpha0")


def test_backbone_levels_match_jax(setup, frames):
    """The last column's four levels, NHWC, within ``LEVEL_REL`` of each
    level's largest entry."""
    _, _, variables, tm = setup
    x = frames.reshape((-1,) + frames.shape[2:])
    b = tm.cfg.backbone
    jm = JaxRevCol(channels=b.in_channels, layers=b.revcol_layers,
                   num_subnet=b.revcol_num_subnet, drop_path=0.0)
    params = {"params": tp.jax_tree(variables)["params"]["encoder"][
        "backbone"]}
    ref = jax.jit(lambda p, f: jm.apply(p, f, train=False))(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = tm.encoder.backbone(torch.from_numpy(x))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(tp.to_np(g), r, rtol=0,
                                   atol=LEVEL_REL * np.abs(r).max())


def test_encoder_levels_match_jax(setup, frames):
    """The three FPN levels of the clip's frames."""
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


def test_server_matches_jax(setup):
    """Two streams through both servers (a skipped tick, detach and
    attach, a weight swap, eleven ticks through a 4-frame ring)."""
    jc, tc, _, _ = setup
    variables = tp.init_variables(jc, seed=1)
    js = JaxServer(jcfg.Config(model=jc), tp.jax_tree(variables),
                   max_streams=2, memory_window=WINDOW)
    ts = TorchServer(tcfg.Config(model=tc), convert(variables),
                     max_streams=2, memory_window=WINDOW, device="cpu")
    swap = tp.init_variables(jc, seed=2)
    assert tp.drive_servers(js, ts, swap, (64, 128, 3)) > 0


def test_bf16_encoder_matches_exact_oracle(setup, frames):
    """bf16: the backbone's levels float32 (RevCol computes in float32
    from the frames rounded to bf16, as the JAX module without a dtype
    does), the FPN levels bf16 values (the neck casts its inputs), at
    least ``BF16_EQUAL`` of them bit-equal to JAX's and all within twice
    the port's own one-ulp spread."""
    jc, tc = cfgs(compute_dtype="bfloat16")
    _, _, variables, _ = setup
    jm = JaxPHNet(jc)
    ref = exact_jit(lambda v, f: jm.apply(v, f, method=jm.encode))(
        tp.jax_tree(variables), jnp.asarray(frames))
    tm = tp.torch_model(tc, variables)
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(frames))
        own = tm.encode(torch.from_numpy(one_ulp(frames)))
        levels = tm.encoder.backbone(torch.from_numpy(
            frames[0]).bfloat16().float())
    assert all(x.dtype == torch.float32 for x in levels)
    for g, r, o in zip(got, ref, own):
        g, r, o = tp.to_np(g), np.asarray(r), tp.to_np(o)
        assert g.dtype == np.float32
        np.testing.assert_array_equal(
            g, torch.from_numpy(g).bfloat16().float().numpy())
        assert (g == r).mean() >= BF16_EQUAL
        assert np.abs(g - r).max() <= 2 * np.abs(o - g).max()


def jax_scales_by_key(jc):
    """The JAX package's ``revcol_layer_scales`` of ``jc``'s tree, by the
    port's key (``convert.plan``)."""
    b = jc.backbone
    shapes = tp.variable_shapes(jc)
    scales = jax_revcol_layer_scales(shapes["params"], b.revcol_layers,
                                     b.revcol_num_subnet)
    flat = {tuple(str(k.key) for k in path): s for path, s in
            jax.tree_util.tree_leaves_with_path(scales)}
    return {key: flat[path[1:]] for key, (path, _) in plan(
        {"params": shapes["params"]}).items()}


@pytest.mark.parametrize("size", ["small", "revcol_tiny"])
def test_layer_scales_match_jax(size):
    """Every parameter's scale equals the JAX package's, key by key through
    the bridge: the small configuration and revcol_tiny in the VIL
    preset. The head and the neck take 1, the stem the smallest."""
    if size == "small":
        jc, tc = cfgs()
    else:
        jc = dataclasses.replace(jcfg.vil100_config().model, backbone=(
            jcfg.BackboneConfig(kind="revcol")))
        tc = dataclasses.replace(tcfg.vil100_config().model, backbone=(
            tcfg.BackboneConfig(kind="revcol")))
    want = jax_scales_by_key(jc)
    b = tc.backbone
    names = [n for n, _ in TorchPHNet(tc, device="cpu").named_parameters()]
    got = dict(zip(names, revcol_layer_scales(
        names, b.revcol_layers, b.revcol_num_subnet)))
    assert got == want
    assert all(got[n] == 1.0 for n in names if not n.startswith(
        "encoder.backbone."))
    stem = got["encoder.backbone.stem_conv.weight"]
    assert stem == min(got.values()) < 1.0
    assert len(set(got.values())) > 4


@pytest.mark.parametrize("solver", ["adamw", "sgd"])
def test_optimizer_scales_the_whole_update(solver):
    """One update of a parameter at scale s moves it s times as far as at
    scale 1, weight decay included (a decaying matrix and a vector that
    does not decay), as the JAX package's scaled update does; a scale
    list of the wrong length raises."""
    train = tcfg.TrainConfig(solver=solver, weight_decay=0.1,
                             learning_rate=1e-2)
    g = torch.Generator().manual_seed(0)
    base = [torch.randn(4, 3, generator=g, dtype=torch.float64),
            torch.randn(3, generator=g, dtype=torch.float64)]
    grads = [torch.randn(p.shape, generator=g, dtype=torch.float64)
             for p in base]

    def moved(scales):
        params = [torch.nn.Parameter(p.clone()) for p in base]
        for p, gr in zip(params, grads):
            p.grad = gr.clone()
        Optimizer(train, 10, params, scales).step()
        return [p.detach() - b for p, b in zip(params, base)]

    one = moved(None)
    for s in (0.5, 0.25):
        for m, o in zip(moved([s, s]), one):
            torch.testing.assert_close(m, s * o, rtol=1e-9, atol=1e-15)
    with pytest.raises(ValueError, match="lr_scales"):
        Optimizer(train, 10, [torch.nn.Parameter(base[0])], [1.0, 1.0])


def test_trainer_applies_no_scales(setup):
    """``create_train_state`` (what the trainer builds) passes no scales,
    as the JAX trainer passes none: two groups, scale 1."""
    _, tc, _, _ = setup
    state = create_train_state(tcfg.Config(model=tc), 10, "cpu", seed=0)
    groups = state.optimizer.opt.param_groups
    assert state.optimizer.lr_scales == [1.0, 1.0] and len(groups) == 2
    assert [g["weight_decay"] for g in groups][1] == 0.0


def drop_path_grads(tc, variables, frames, labels, seed, save_memory):
    """Gradients of one training forward + criterion with drop path 0.1
    (``dropout_seed=seed``), columns checkpointed or not."""
    tc = dataclasses.replace(tc, backbone=dataclasses.replace(
        tc.backbone, revcol_drop_path=0.1, revcol_save_memory=save_memory))
    model = tp.torch_model(tc, variables)
    model.train()
    outs, _ = model.train_forward(torch.from_numpy(frames),
                                  torch.from_numpy(labels), seed)
    loss, _ = TorchCriterion(tc, tcfg.LossConfig())(
        outs, torch.from_numpy(labels))
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if n.startswith("encoder.backbone.")}


def test_checkpointed_columns_give_the_same_gradient(setup):
    """Drop path 0.1: the gradient with every column but the first
    recomputed in the backward equals the one without, under one seed
    (the recompute draws the same masks from the seed, not from a live
    generator), within 1e-6 of each leaf's largest entry; another seed, or
    none (no drop path), changes them by far more."""
    _, tc, variables, _ = setup
    rng = np.random.default_rng(3)
    frames = rng.normal(size=(1, 2, 64, 128, 3)).astype(np.float32)
    labels = ttp.clip_labels(rng, tc.lane, tc.img_w)
    remat = drop_path_grads(tc, variables, frames, labels, 5, True)
    plain = drop_path_grads(tc, variables, frames, labels, 5, False)
    other = drop_path_grads(tc, variables, frames, labels, 6, True)
    off = drop_path_grads(tc, variables, frames, labels, None, True)
    moved = {"other seed": 0, "no drop path": 0}
    for n, g in remat.items():
        scale = g.abs().max().item() + 1e-12
        assert (g - plain[n]).abs().max().item() <= 1e-6 * scale, n
        for tag, run in (("other seed", other), ("no drop path", off)):
            moved[tag] += (run[n] - g).abs().max().item() > 1e-2 * scale
    assert min(moved.values()) > len(remat) // 2, moved


def test_drop_path_only_in_training(setup, frames):
    """The seed changes the encoder's levels in train mode only; eval mode
    (serving, the pipeline) is deterministic."""
    _, tc, variables, _ = setup
    tc = dataclasses.replace(tc, backbone=dataclasses.replace(
        tc.backbone, revcol_drop_path=0.1))
    model = tp.torch_model(tc, variables)
    x = torch.from_numpy(frames)
    with torch.no_grad():
        plain = model.encode(x)
        assert all(torch.equal(a, b) for a, b in zip(plain,
                                                     model.encode(x, 7)))
        model.train()
        dropped = model.encode(x, 7)
        again = model.encode(x, 7)
    assert all(torch.equal(a, b) for a, b in zip(dropped, again))
    assert not torch.equal(dropped[0], plain[0])
