"""OpenLane-V's multi-scale head (the reference's ``Router4OLV2``) in the
port against the JAX package, on the small configuration of
``torch_parity.small_ms_cfg`` (``tests/test_head_ms.py``'s values: 96x192
frames, 32 priors, 24 offsets, the backbone's first three stages into
per-level FPN widths (4, 8, 16), points (6, 12, 24) over channels (16, 8,
4), a 32-wide decode, a window of 3 frames): GroupNorm, ``ConvRouter``,
the V2 ``DynamicConv`` (float32, w8, int8), ``bilinear_sample``, the
encoder's levels, one head frame with memory, the quantized head, a clip
longer than the window through ``detect``, the server, the pipeline and
the parameter bridge of the full-width preset.

Tolerances, and why. Modules on identical inputs: within 1e-5 (GroupNorm,
the router, ``bilinear_sample``) and 1e-4 (DynamicConv, the encoder;
float32 sums in other orders). The head frame in float32: stages 0 and 1
(stride-16 and stride-8 levels) within 1e-4, the router scores ``diff``
within 1e-4 at every stage; stage 2's predictions and memorized features
within 1e-3. Stage 2 samples the stride-4 level at coordinates that carry
the earlier stages' ~1e-5 differences, and random weights make that level
rough, so the head amplifies them: perturbing the head's input features by
1e-6 relative (six draws) moved the port's own stage-2 outputs by up to
3.0e-4 (stage 0: 3.5e-5, stage 1: 1.6e-4); the port against JAX measured
5.5e-5 / 4.3e-5 / 3.0e-4 at stages 0 / 1 / 2 and 1.8e-6 on ``diff``.
Clips, servers and pipelines keep the last stage's rows and memorize its
features, so they are held within 1e-3, keep sets equal (a clip's kept
rows moved 1.4e-4 under the same perturbation, against JAX 2.3e-4).

The quantized heads (self-perturbation, as ``tests/test_torch_quant.py``)
are held per column group of the predictions (cls logits, geometry and
length, xs), on ``diff`` and on the memorized features, each by its
largest and its 90th-percentile difference. The same perturbation (six
draws, w8 and int8) moved the port's own outputs by at most / at the 90th
percentile: cls 4.0e-1 / 1.3e-2, geometry and length 5.7e-4 / 1.6e-5, xs
2.6e-3 / 3.2e-5, ``diff`` 2.6e-3 / 9.4e-6, features 2.1e-1 / 4.2e-3. The
port against JAX measured cls 1.1e-1 / 3.7e-3, geometry and length
1.5e-4 / 4.5e-6, xs 4.8e-4 / 8.8e-6, ``diff`` 8.7e-5 / 2.8e-6, features
8.2e-2 / 9.8e-4 (the JAX package quantizes this head's weights inside its
compiled graph, by a reciprocal scale, the port outside it by a division,
so rare weight codes differ by one). Bounds: :data:`QUANT_BOUNDS`.
"""

import dataclasses
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phnet_torch.config as tcfg
import phnet_tpu.config as jcfg
from phnet_torch.convert import convert, plan
from phnet_torch.models import PHNet as TorchPHNet
from phnet_torch.models.dynamic_conv import DynamicConv as TorchDynamicConv
from phnet_torch.models.head_ms import ConvRouter, GroupNorm
from phnet_torch.models.positional import AnchorPositionalEncoding
from phnet_torch.ops.sampler import bilinear_sample
from phnet_torch.serving import StreamingServer as TorchServer
from phnet_tpu.models import PHNet as JaxPHNet
from phnet_tpu.models.dynamic_conv import DynamicConv as JaxDynamicConv
from phnet_tpu.models.head_ms import ConvRouter as JaxConvRouter
from phnet_tpu.models.head_ms import MultiScaleLaneHead as JaxHead
from phnet_tpu.ops.sampler import bilinear_sample as jax_bilinear_sample
from phnet_tpu.serving import StreamingServer as JaxServer

import torch_parity as tp

B = 2
CHUNK = 4  # a clip chunk longer than the window (3)
SEED = 5  # weights whose keeps vary (2 to 4 a frame) at confidence 0.3
FRAME = (96, 192, 3)
STAGES = ((6, 16), (12, 8), (24, 4))  # (points, channels) a stage
HEAD_OUTPUTS = ("pred_fir", "pred_sec", "diff", "attn_feat")
CLIP_OUTPUTS = ("kept", "kept_valid", "num_kept", "memory values",
                "memory mask")
F32_ATOL = 1e-3  # clips, servers, pipelines: the last stage's outputs
STAGE_ATOL = (1e-4, 1e-4, 1e-3)  # stage 2 samples the stride-4 level
# (largest, 90th percentile) of |port - JAX| in w8 and int8: the
# predictions' column groups (2 cls, start_y / start_x / theta / length,
# xs), the router scores and the memorized features
QUANT_BOUNDS = {"cls": (5e-1, 2e-2), "geometry": (1e-3, 3e-5),
                "xs": (5e-3, 5e-5), "diff": (5e-3, 2e-5),
                "attn_feat": (5e-1, 5e-3)}
PRED_GROUPS = {"cls": slice(0, 2), "geometry": slice(2, 6),
               "xs": slice(6, None)}


@pytest.fixture(scope="module")
def setup():
    jc, tc = tp.small_ms_cfg(jcfg), tp.small_ms_cfg(tcfg)
    variables = tp.init_variables(jc, seed=SEED)
    return jc, tc, variables, tp.torch_model(tc, variables)


def head_params(variables, name):
    return tp.jax_tree(variables["params"]["frame"]["head"][name])


def draw(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("n,c,l,groups", [(6, 8, 24, 8), (5, 4, 12, 4),
                                          (3, 1, 96, 1)])
def test_group_norm_matches_flax(n, c, l, groups):
    """flax's GroupNorm (fast variance, epsilon 1e-6) on [N, L, C]
    against the port's on [N, C, L], within 1e-5; inputs off zero mean."""
    x = draw(n * c + l, n, l, c) * 2.0 + 0.5
    scale, bias = draw(1, c) * 0.1 + 1.0, draw(2, c) * 0.1
    ref = fnn.GroupNorm(num_groups=groups).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    gn = GroupNorm(groups, c, eps=1e-6)
    gn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    got = gn(torch.from_numpy(x.transpose(0, 2, 1).copy()))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 1),
                               np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("stage", range(3))
def test_conv_router_matches_jax(setup, stage):
    """The stage's router on [B, A, C, P] profiles (the weights of the
    drawn model, through ``convert``): scores within 1e-5."""
    _, _, variables, tm = setup
    points, channels = STAGES[stage]
    feats = draw(stage, B, 32, channels, points)
    ref = JaxConvRouter(channels=channels, points=points,
                        last_channels=4).apply(
        {"params": head_params(variables, f"router_{stage}")},
        jnp.asarray(feats))
    router = tm.head.routers[stage]
    assert isinstance(router, ConvRouter)
    with torch.no_grad():
        got = router(torch.from_numpy(feats))
    assert got.shape == (B, 32, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("stage,mode", [
    (0, "none"), (1, "none"), (2, "none"), (0, "w8"), (2, "w8"),
    (0, "int8"), (2, "int8")])
def test_dynamic_conv_v2_matches_jax(setup, stage, mode):
    """The V2 DynamicConv of a stage (C channels into the shared 32,
    ``param_reduction=4``, ``out_hidden`` 64; stage 0 collapses its first
    generator, stage 2 keeps it factored, as ``collapse_wins`` decides),
    on identical inputs: within 1e-4 in float32 and int8, 1e-2 in w8 (each
    package multiplies a collapsed chain's two kernels in f32 in its own
    order, so a few w8 weight codes land one step apart: measured
    6.4e-3)."""
    _, _, variables, _ = setup
    points, channels = STAGES[stage]
    kw = dict(feat_size=points, hidden_dim=channels, param_reduction=4,
              out_dim=32, out_hidden=64, pro_dim=32, quantize=mode)
    pro, roi = draw(10 + stage, B, 32, 32), draw(20 + stage, B, 32, points,
                                                 channels)
    p = variables["params"]["frame"]["head"][f"dyn_head_{stage}"]
    ref = jax.jit(lambda v, a, b: JaxDynamicConv(**kw).apply(v, a, b))(
        {"params": tp.jax_tree(p)}, jnp.asarray(pro), jnp.asarray(roi))
    sd = convert({"params": {"frame": {"head": {"dyn_heads": p}}}})
    mod = TorchDynamicConv(**kw)
    mod.load_state_dict({k.split("dyn_heads.")[1]: v
                         for k, v in sd.items()})
    with torch.no_grad():
        got = mod(torch.from_numpy(pro), torch.from_numpy(roi))
    assert got.shape == (B, 32, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-2 if mode == "w8" else 1e-4)


@pytest.mark.parametrize("h,w,scale", [(24, 48, 1.0), (6, 12, 1.3),
                                       (1, 7, 0.5)])
def test_bilinear_sample_matches_jax(h, w, scale):
    """[B, H, W, C] maps sampled at [B, A, P] coordinates, some outside
    the map (zero padding), against JAX's [C, H, W] sampler per stream:
    within 1e-5."""
    feat = draw(h * w, B, h, w, 5)
    rng = np.random.default_rng(h + w)
    x = (rng.uniform(-0.2, 1.2, (B, 9, 4)) * (w - 1) * scale).astype(
        np.float32)
    y = (rng.uniform(-0.2, 1.2, (B, 9, 4)) * (h - 1)).astype(np.float32)
    ref = jax.vmap(lambda f, a, b: jax_bilinear_sample(
        jnp.moveaxis(f, -1, 0), a, b))(*map(jnp.asarray, (feat, x, y)))
    got = bilinear_sample(*map(torch.from_numpy, (feat, x, y)))
    assert got.shape == (B, 9, 4, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.fixture(scope="module")
def levels(setup):
    jc, _, variables, tm = setup
    frames = tp.seeded_frames(1, (B, 1) + FRAME)
    jm = JaxPHNet(jc)
    ref = jax.jit(lambda v, f: jm.apply(v, f, method=jm.encode))(
        tp.jax_tree(variables), jnp.asarray(frames))
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(frames))
    return got, ref


@pytest.mark.parametrize("level", range(3))
def test_encoder_levels(levels, level):
    """The backbone's stages 0-2 through the per-level FPN (widths 4, 8,
    16, 1x1 projections on the top-down path): strides 4, 8, 16, within
    1e-4."""
    got, ref = levels
    g, r = tp.to_np(got[level]), np.asarray(ref[level])
    assert g.shape == r.shape == (1, B, 24 >> level, 48 >> level,
                                  4 << level)
    np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)


def run_head(setup, mode="none"):
    """One head frame on injected FPN features and a memory bank with
    some valid slots (stream 1 none), JAX and port."""
    jc, tc, variables, tm = setup
    if mode != "none":
        jc = dataclasses.replace(jc, quantize=mode)
        tm = tp.torch_model(dataclasses.replace(tc, quantize=mode),
                            variables)
    rng = np.random.default_rng(2)
    shapes = [(B, 24, 48, 4), (B, 12, 24, 8), (B, 6, 12, 16)]
    feats = [rng.normal(size=s).astype(np.float32) for s in shapes]
    m, d = 3 * 5, jc.head.attn_dim
    mem_vals = rng.normal(size=(B, 3, m, d)).astype(np.float32)
    mem_mask = rng.uniform(size=(B, m)) < 0.5
    mem_mask[1] = False
    ref = jax.jit(lambda p, f, v, mk: JaxHead(jc).apply(
        {"params": p}, f, v, mk, train=False))(
        tp.jax_tree(variables["params"]["frame"]["head"]),
        tuple(map(jnp.asarray, feats)), jnp.asarray(mem_vals),
        jnp.asarray(mem_mask))
    with torch.no_grad():
        got = tm.head(tuple(map(torch.from_numpy, feats)),
                      torch.from_numpy(mem_vals), torch.from_numpy(mem_mask))
    return got, ref


@pytest.fixture(scope="module")
def head_frame(setup):
    return run_head(setup)


@pytest.mark.parametrize("name", HEAD_OUTPUTS)
def test_head_one_frame_with_memory(head_frame, name):
    """Each stage's outputs within its bound (:data:`STAGE_ATOL`; ``diff``
    within 1e-4 at every stage; see the module docstring); the memorized
    features are the decode width (positions added)."""
    got, ref = head_frame
    g, r = tp.to_np(getattr(got, name)), np.asarray(getattr(ref, name))
    assert g.shape == r.shape and g.shape[0] == len(STAGE_ATOL)
    for s, atol in enumerate(STAGE_ATOL):
        np.testing.assert_allclose(g[s], r[s], rtol=0,
                                   atol=1e-4 if name == "diff" else atol,
                                   err_msg=f"stage {s}")
    assert got.attn_feat.shape[-1] == 32


@pytest.mark.parametrize("mode", ["w8", "int8"])
def test_quantized_head_matches_jax(setup, mode):
    """The head frame with quantized DynamicConv chains (13 products a
    frame at the full preset's widths): each column group of both
    branches' predictions, the router scores and the memorized features
    within their largest and 90th-percentile bounds
    (:data:`QUANT_BOUNDS`; see the module docstring)."""
    got, ref = run_head(setup, mode)
    parts = []
    for name in HEAD_OUTPUTS:
        g, r = tp.to_np(getattr(got, name)), np.asarray(getattr(ref, name))
        if name.startswith("pred"):
            parts += [(group, f"{name} {group}", g[..., cols], r[..., cols])
                      for group, cols in PRED_GROUPS.items()]
        else:
            parts.append((name, name, g, r))
    for group, where, g, r in parts:
        largest, p90 = QUANT_BOUNDS[group]
        np.testing.assert_allclose(g, r, rtol=0, atol=largest,
                                   err_msg=where)
        assert np.percentile(np.abs(g - r), 90) <= p90, where


@pytest.mark.parametrize("override,check", [
    ({"decoder_ffn_dim": 48},
     lambda m: m.head.temporal_decoder.layers[0].ffn1.out_features == 48),
    ({"dyn_param_reduction": 8},
     lambda m: all(g.gen1_a.out_features == g.gen1_b.out_features // 8
                   for g in m.head.dyn_heads)),
    ({"pos_normalize": True, "pos_temperature": 16.0},
     lambda m: torch.equal(m.head.pos_encoding(), AnchorPositionalEncoding(
         32, 32, "sine", 16.0, True)())),
    ({"pos_encoding": "learned"},
     lambda m: tuple(m.head.pos_encoding().shape) == (32, 32)
     and "head.pos_encoding.embedding" in m.state_dict()),
])
def test_head_reads_its_settings(override, check):
    """The multi-scale head takes its positions, its decoder's ffn width
    and its generators' reduction from ``cfg.head``, so an override of the
    preset's values is the one that runs."""
    tc = tp.small_ms_cfg(tcfg)
    model = TorchPHNet(dataclasses.replace(
        tc, head=dataclasses.replace(tc.head, **override)), device="cpu")
    assert check(model)


@pytest.fixture(scope="module")
def pipelines(setup):
    jc, tc, variables, _ = setup
    return tp.pipelines(jc, tc, variables, CHUNK)


@pytest.fixture(scope="module")
def clip(pipelines):
    out = tp.run_chunk(pipelines("none"),
                       tp.seeded_frames(1, (1, CHUNK) + FRAME))
    assert out["memory values"][0].shape[2] == 3  # the window: it wraps
    return out


@pytest.mark.parametrize("name", CLIP_OUTPUTS)
def test_clip_through_detect(clip, name):
    """A clip of 4 frames (longer than the window of 3) through
    ``detect``: kept rows and memory values within 1e-3, the rest equal;
    lanes kept."""
    tp.check_clip_output(clip, name, F32_ATOL)


def test_server_matches_jax(setup):
    """Two streams through both servers with the window of 3 frames from
    the config: a skipped tick, detach and attach, a weight swap, eleven
    ticks (the ring wraps three times)."""
    jc, tc, variables, _ = setup
    js = JaxServer(jcfg.Config(model=jc), tp.jax_tree(variables),
                   max_streams=2)
    ts = TorchServer(tcfg.Config(model=tc), convert(variables),
                     max_streams=2, device="cpu")
    assert ts.window == js.window == 3
    swap = tp.init_variables(jc, seed=SEED - 1)
    assert tp.drive_servers(js, ts, swap, FRAME, atol=F32_ATOL) > 0


def test_pipeline_matches_jax(pipelines, tmp_path):
    """Clips of 5 and 4 frames in chunks of 4 (each chunk crosses the
    window of 3; the memory is carried across chunks; the last chunk is
    padded), emitted in the OL format."""
    jpipe, tpipe = pipelines("none")
    assert tpipe.memory_window == jpipe.memory_window == 3
    assert tp.compare_pipelines(jpipe, tpipe, tp.ol_clips(FRAME),
                                tmp_path) > 0


def test_convert_round_trip():
    """The full-width preset: every JAX leaf (the routers' Conv1d and
    GroupNorm, the branch stacks, the per-level FPN and its projections)
    maps once onto the port's state_dict, shapes equal."""
    cfg = jcfg.openlane_multiscale_config().model
    model = JaxPHNet(cfg)
    frames = jax.ShapeDtypeStruct((1, 2, cfg.img_h, cfg.img_w, 3),
                                  jnp.float32)
    shapes = jax.eval_shape(lambda f: model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, f,
        None, train=False), frames)
    mapping = plan(shapes)
    leaves = jax.tree_util.tree_leaves(shapes)
    assert len(mapping) == len(leaves) == 268
    assert sum(math.prod(x.shape) for x in leaves) == 61_006_441
    sd = {k: tuple(v.shape) for k, v in TorchPHNet(
        tcfg.openlane_multiscale_config().model,
        device="meta").state_dict().items()}
    assert set(mapping) == set(sd)
    for key, (path, shape) in mapping.items():
        assert shape == sd[key], (path, shape, sd[key])
    assert mapping["head.routers.0.conv1.weight"][1] == (32, 64, 3)
    assert mapping["encoder.neck.upsample.1.weight"][1] == (32, 64, 1, 1)
    assert mapping["head.reg_sec.out.weight"][1] == (76, 256)


# -- bf16 (the JAX package's compute_dtype="bfloat16") ----------------------

@pytest.fixture(scope="module")
def bf16_levels(setup):
    """The encoder's levels in bf16, the JAX side compiled without XLA's
    excess precision (``test_torch_bf16.exact_jit``)."""
    from test_torch_bf16 import exact_jit

    jc, tc, variables, _ = setup
    jc, tc = (dataclasses.replace(c, compute_dtype="bfloat16")
              for c in (jc, tc))
    frames = tp.seeded_frames(1, (B, 1) + FRAME)
    jm = JaxPHNet(jc)
    ref = exact_jit(lambda v, f: jm.apply(v, f, method=jm.encode))(
        tp.jax_tree(variables), jnp.asarray(frames))
    with torch.no_grad():
        got = tp.torch_model(tc, variables).encode(torch.from_numpy(frames))
    return got, ref


@pytest.mark.parametrize("level", range(3))
def test_bf16_encoder_levels_bit_equal(bf16_levels, level):
    """The per-level FPN (widths 4, 8, 16 and the 1x1 projections) in
    bf16 with PR 10's rounding order: each level float32 out, bf16 values,
    bit-equal to the JAX package's."""
    got, ref = bf16_levels
    g, r = tp.to_np(got[level]), np.asarray(ref[level])
    assert got[level].dtype == torch.float32 and g.shape == r.shape
    assert torch.equal(got[level], got[level].bfloat16().float())
    np.testing.assert_array_equal(g, r)


def test_bf16_head_computes_in_float32(setup):
    """The multi-scale head reads no compute dtype (as
    ``phnet_tpu/models/head_ms.py``): in a bf16 model only the encoder
    casts; the head's modules, its outputs and the memory are float32,
    and on equal features its outputs equal the float32 model's."""
    _, tc, variables, tm = setup
    bf = tp.torch_model(dataclasses.replace(tc, compute_dtype="bfloat16"),
                        variables)
    assert bf.encoder.dtype == torch.bfloat16
    assert all(getattr(m, "dtype", None) is None
               for m in bf.head.modules())
    rng = np.random.default_rng(8)
    feats = tuple(torch.from_numpy(rng.normal(size=(B, 24 >> s, 48 >> s,
                                                    4 << s)).astype(
        np.float32)) for s in range(3))
    mem = torch.from_numpy(rng.normal(size=(B, 3, 6, 32)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=(B, 6)) < 0.5)
    with torch.no_grad():
        got, ref = bf.head(feats, mem, mask), tm.head(feats, mem, mask)
    for name in HEAD_OUTPUTS:
        assert getattr(got, name).dtype == torch.float32
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_bf16_clip_matches_jax(setup):
    """``PHNet.forward`` in bf16 over a 3-frame clip of 4 streams against
    the ``exact_jit`` JAX clip, by the one-ulp method of
    ``test_torch_bf16.py``: keep counts and kept rows on the robust slots,
    the memory on the robust streams. A quarter of the slots at least
    are robust (measured 3 of 12 in each package: the head's hard routing
    switches an anchor's branch whole under one-ulp noise, which moves its
    kept row past ``KEPT_ATOL`` while the keep count stays)."""
    import test_torch_bf16 as tb

    jc, tc, variables, _ = setup
    jc, tc = (dataclasses.replace(c, compute_dtype="bfloat16")
              for c in (jc, tc))
    frames = tp.seeded_frames(1, (4, tb.T) + FRAME)
    jm = JaxPHNet(jc)
    jclip = tb.exact_jit(lambda v, f: jm.apply(v, f, None, train=False))
    tm = tp.torch_model(tc, variables)
    jax_runs, port_runs = [], []
    for copy in tb.ulp_copies(frames):
        out, mem = jclip(tp.jax_tree(variables), jnp.asarray(copy))
        jax_runs.append((np.asarray(out.num_kept),
                         tb.masked_rows(out.kept, out.kept_valid),
                         np.asarray(mem.values)))
        with torch.no_grad():
            out, mem = tm(torch.from_numpy(copy))
        assert out.kept.dtype == mem.values.dtype == torch.float32
        port_runs.append((tp.to_np(out.num_kept),
                          tb.masked_rows(out.kept, out.kept_valid),
                          tp.to_np(mem.values)))
    ref = {"num_kept": jax_runs[0][0], "kept": jax_runs[0][1],
           "memory": jax_runs[0][2], "robust": tb.robust_slots(jax_runs)}
    tb.check_against(ref, port_runs, robust_min=0.25)
