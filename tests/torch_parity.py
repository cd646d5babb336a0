"""Shared set-up of the port's parity tests (``test_torch_*.py``).

Small configurations are built in both packages from the same keyword
arguments: the VIL one (the ``__graft_entry__`` dry-run geometry: 64x128
frames, 32 priors, 12 offsets, 8 sample points, widths 16) and two
OpenLane-V ones at 96x192 with 32 priors and 24 offsets, the multi-scale
head's (``tests/test_head_ms.py``'s values: points (6, 12, 24) over
channels (16, 8, 4), window 3) and the single head's (the OL lane layout,
learned positions, a separate offset head, soft routing, window 2); and
the prior-propagation head's (``tests/test_head_v3.py``'s values: 96x192,
32 priors, 12 offsets, K = 4 slots, one frame carried).
Weights are drawn with numpy for the JAX package's parameter tree and
reach the port through ``phnet_torch.convert``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import phnet_torch.config as tcfg
import phnet_tpu.config as jcfg
from phnet_torch.convert import convert
from phnet_torch.models import PHNet as TorchPHNet
from phnet_tpu.models import PHNet as JaxPHNet


def small_model_cfg(cfgmod, window: int = 0):
    """The small ModelConfig, from ``phnet_tpu.config`` or
    ``phnet_torch.config`` (same fields, same values)."""
    return cfgmod.ModelConfig(
        img_h=64,
        img_w=128,
        lane=cfgmod.LaneSpec(n_offsets=12, n_lengths=2),
        backbone=cfgmod.BackboneConfig(in_channels=(8, 16, 24, 32)),
        neck=cfgmod.NeckConfig(in_channels=(16, 24, 32), out_channels=16,
                               num_outs=3),
        head=cfgmod.HeadConfig(num_priors=32, sample_points=8,
                               fc_hidden_dim=16, prior_feat_channels=16,
                               decoder_ffn_dim=32),
        memory=cfgmod.MemoryConfig(window=window),
        test=cfgmod.TestParams(conf_threshold=0.3, nms_thres=20.0,
                               nms_topk=4),
        max_lanes=4,
    )


# the other backbones at small widths (``BackboneConfig`` keywords): RevCol
# of 3 columns, layers (1, 1, 2, 1); the Bottleneck ResNet-50 (stage
# outputs 4x the widths); the GroupNorm ResNet-18 at widths wide enough
# for groups of 2 and 3 channels (the stem's 64 too)
BACKBONES = {
    "revcol": (dict(kind="revcol", in_channels=(8, 16, 24, 32),
                    revcol_layers=(1, 1, 2, 1), revcol_num_subnet=3,
                    revcol_drop_path=0.0), (16, 24, 32)),
    "r50": (dict(depth=50, in_channels=(8, 16, 24, 32)), (64, 96, 128)),
    "gn": (dict(norm="group", in_channels=(32, 64, 96, 128)),
           (64, 96, 128)),
}


def small_backbone_cfg(cfgmod, backbone: str, window: int = 0, **kw):
    """The small VIL ModelConfig with the backbone ``backbone`` (a key of
    :data:`BACKBONES`; ``kw`` overrides its ``BackboneConfig`` fields) and
    its neck's input widths."""
    fields, neck_in = BACKBONES[backbone]
    cfg = small_model_cfg(cfgmod, window)
    return dataclasses.replace(
        cfg, backbone=cfgmod.BackboneConfig(**{**fields, **kw}),
        neck=dataclasses.replace(cfg.neck, in_channels=neck_in))


def jax_cfg(window: int = 0):
    return small_model_cfg(jcfg, window)


def torch_cfg(window: int = 0):
    return small_model_cfg(tcfg, window)


def small_ol_cfg(cfgmod, quantize: str = "none"):
    """The small OpenLane-V single-head ModelConfig (``Router4OL``)."""
    return cfgmod.ModelConfig(
        img_h=96,
        img_w=192,
        lane=cfgmod.LaneSpec(n_offsets=24, n_lengths=1),
        backbone=cfgmod.BackboneConfig(in_channels=(8, 16, 24, 32)),
        neck=cfgmod.NeckConfig(in_channels=(16, 24, 32), out_channels=16,
                               num_outs=3),
        head=cfgmod.HeadConfig(num_priors=32, sample_points=8,
                               fc_hidden_dim=16, prior_feat_channels=16,
                               decoder_ffn_dim=32, pos_encoding="learned",
                               separate_offset_head=True),
        memory=cfgmod.MemoryConfig(window=2),
        test=cfgmod.TestParams(conf_threshold=0.5, nms_thres=20.0,
                               nms_topk=4),
        max_lanes=4,
        routing="soft",
        crop_size=480,
        org_size=(1280, 1920),
        quantize=quantize,
    )


def small_ms_cfg(cfgmod, quantize: str = "none"):
    """The small multi-scale ModelConfig (``Router4OLV2``;
    ``tests/test_head_ms.py::tiny_ms_cfg``)."""
    return cfgmod.ModelConfig(
        img_h=96,
        img_w=192,
        lane=cfgmod.LaneSpec(n_offsets=24, n_lengths=1),
        backbone=cfgmod.BackboneConfig(in_channels=(8, 16, 24, 32),
                                       out_indices=(0, 1, 2)),
        neck=cfgmod.NeckConfig(in_channels=(8, 16, 24),
                               out_channels=(4, 8, 16), num_outs=3),
        head=cfgmod.HeadConfig(num_priors=32, fc_hidden_dim=32,
                               decoder_ffn_dim=64, dyn_param_reduction=4,
                               pos_temperature=64.0, pos_normalize=False,
                               variant="multi",
                               ms_sample_points=(6, 12, 24),
                               ms_channels=(16, 8, 4)),
        memory=cfgmod.MemoryConfig(window=3),
        test=cfgmod.TestParams(conf_threshold=0.3, nms_thres=20.0,
                               nms_topk=4),
        max_lanes=4,
        routing="hard",
        crop_size=480,
        org_size=(1280, 1920),
        quantize=quantize,
    )


def small_v3_cfg(cfgmod, quantize: str = "none",
                 conf_threshold: float = 0.5):
    """The small prior-propagation ModelConfig (``Router4OLV3``;
    ``tests/test_head_v3.py::v3_cfg``: 96x192 frames, 32 priors, 12
    offsets, K = 4 propagated slots, a one-frame memory)."""
    return cfgmod.ModelConfig(
        img_h=96,
        img_w=192,
        lane=cfgmod.LaneSpec(n_offsets=12, n_lengths=1),
        backbone=cfgmod.BackboneConfig(in_channels=(8, 16, 24, 32)),
        neck=cfgmod.NeckConfig(in_channels=(16, 24, 32), out_channels=16,
                               num_outs=3),
        head=cfgmod.HeadConfig(num_priors=32, sample_points=8,
                               fc_hidden_dim=16, prior_feat_channels=16,
                               decoder_ffn_dim=32, pos_encoding="learned",
                               separate_offset_head=True,
                               propagate_priors=True),
        memory=cfgmod.MemoryConfig(window=1),
        test=cfgmod.TestParams(conf_threshold=conf_threshold,
                               nms_thres=20.0, nms_topk=4),
        max_lanes=4,
        routing="soft",
        crop_size=480,
        org_size=(1280, 1920),
        quantize=quantize,
    )


def check_fields(got, ref, where="model", differ=None):
    """Every field of the port's dataclass ``got`` equals the same field
    of the JAX package's ``ref``, recursively (fields the JAX package has
    and the port has not are not compared), but the paths in ``differ``
    ({"model.head.x": the port's value}), which must hold the port's value
    and differ from JAX's."""
    differ = differ or {}
    for f in dataclasses.fields(got):
        value, want = getattr(got, f.name), getattr(ref, f.name)
        path = f"{where}.{f.name}"
        if dataclasses.is_dataclass(value):
            check_fields(value, want, path, differ)
        elif path in differ:
            assert value == differ[path] != want, path
        else:
            assert value == want, path


def variable_shapes(cfg):
    """The JAX PHNet's ``variables`` tree as ``ShapeDtypeStruct``s (traced,
    not compiled)."""
    model = JaxPHNet(cfg)
    frames = jax.ShapeDtypeStruct((1, 2, cfg.img_h, cfg.img_w, 3),
                                  jnp.float32)
    return jax.eval_shape(
        lambda f: model.init({"params": jax.random.key(0),
                              "dropout": jax.random.key(1)}, f, None,
                             train=False), frames)


def init_variables(cfg, seed: int = 0, cls_std: float = 1.0,
                   lane_length: float = 0.5):
    """numpy ``variables`` for the JAX PHNet, drawn from ``seed``: kernels
    from N(0, 1/fan_in), router taps and anchors as the JAX init makes
    them, and noise on what the JAX init leaves constant (biases, norm
    scales, BatchNorm statistics) so that a mis-mapped leaf shows. The cls
    head outputs of both branches are drawn with ``cls_std`` so that
    scores spread well
    away from the confidence threshold and from each other; the other
    head outputs keep the JAX init's 1e-3 scale, but for a bias of
    ``lane_length`` on the valid-length output, so that kept lanes span
    several rows and decode to points. RevCol's layer scales ``gamma``
    (1e-6 at init, which would hide any error in a block) are drawn from
    N(0, 0.5) and its ``alpha`` (0.5 at init) from U(-1, 1), led by 0,
    -5e-4 and 5e-4 (inside the clamp's 1e-3) in every leaf."""
    from phnet_tpu.geometry import build_prior_embeddings

    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        normal = lambda std: rng.normal(0.0, std, shape)  # noqa: E731
        if name.endswith("['var']"):
            x = 1.0 + rng.uniform(0.0, 0.5, shape)
        elif name.endswith("['mean']"):
            x = normal(0.05)
        elif ("heads_" in name and "out0_" in name) or (
                "['cls_" in name and "['out']" in name):
            x = normal(cls_std)
        elif ("heads_" in name and "out" in name) or (
                "['reg_" in name and "['out']" in name):
            x = normal(1e-3)
            if name.endswith("out1_bias']") or (
                    "['reg_" in name and name.endswith("['bias']")):
                x[3] += lane_length
        elif "heads_" in name and "kernel" in name:
            x = normal(1.0 / np.sqrt(shape[1]))
        elif name.endswith("['kernel']"):
            x = normal(1.0 / np.sqrt(np.prod(shape[:-1])))
        elif name.endswith("['taps']"):
            x = rng.uniform(-1.0 / 3.0, 1.0 / 3.0, shape)
        elif name.endswith("['ln_params']"):
            x = normal(0.05)
            x[[0] + [2 + 4 * b + o for b in range(shape[0] // 4)
                     for o in (0, 2)]] += 1.0
        elif name.endswith("['prior_embeddings']"):
            x = build_prior_embeddings(shape[0]) + normal(0.01)
        elif name.endswith("['pro_embedding']"):
            x = normal(1.0)
        elif name.endswith("['embedding']"):  # learned positions
            x = rng.uniform(0.0, 1.0, shape)
        elif name.endswith("['scale']"):
            x = 1.0 + normal(0.05)
        elif name.endswith("['gamma']"):
            x = normal(0.5)
        elif "['alpha" in name:
            x = rng.uniform(-1.0, 1.0, shape)
            x[:3] = (0.0, -5e-4, 5e-4)
        else:  # biases
            x = normal(0.05)
        return np.asarray(x, dtype=np.float32)

    return jax.tree_util.tree_map_with_path(draw, variable_shapes(cfg))


def jax_tree(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def torch_model(cfg, variables) -> TorchPHNet:
    model = TorchPHNet(cfg, device="cpu")
    model.load_state_dict(convert(variables), strict=True)
    return model


def seeded_frames(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- OpenLane-V servers and pipelines, JAX against the port -----------------

OL_SIZE = (800, 1920)  # OL's coordinate frame: 1280 x 1920 less 480 rows


def server_schedule():
    """Ticks of two streams (stream: frame seed), with stream 1 skipping
    tick 2, detached and re-attached (fresh memory) before tick 4, and new
    weights before tick 6: eleven ticks, past three wraps of a 2- or
    3-frame ring."""
    return [{0: 10, 1: 20}, {0: 11, 1: 21}, {0: 12}, {0: 13, 1: 23},
            "reattach", {0: 14, 1: 30}, {0: 15, 1: 31}, "swap",
            {0: 16, 1: 32}, {0: 17}, {0: 18, 1: 34}, {0: 19, 1: 35},
            {0: 20, 1: 36}]


def drive_servers(js, ts, swap_variables, frame_shape, atol=1e-4):
    """Run :func:`server_schedule` through a JAX and a port server of two
    streams: per tick the valid slots and the memory mask equal, kept rows
    within ``atol``, decoded lanes equal in count and within ``atol``.
    Returns the number of decoded lanes."""
    from phnet_torch.convert import convert

    for server in (js, ts):
        assert (server.attach(), server.attach()) == (0, 1)
    n_lanes = 0
    for tick in server_schedule():
        if tick == "reattach":
            for server in (js, ts):
                server.detach(1)
                assert server.attach() == 1
            continue
        if tick == "swap":
            js.update_variables(jax_tree(swap_variables))
            ts.update_variables(convert(swap_variables))
            continue
        frames = {sid: seeded_frames(seed, frame_shape)
                  for sid, seed in tick.items()}
        jk, jvalid, jsids = js.step_async(frames)
        tk, tvalid, tsids = ts.step_async(frames)
        assert jsids == tsids
        np.testing.assert_array_equal(to_np(tvalid), np.asarray(jvalid))
        np.testing.assert_allclose(to_np(tk), np.asarray(jk), rtol=0,
                                   atol=atol)
        np.testing.assert_array_equal(to_np(ts.memory.mask),
                                      np.asarray(js.memory.mask))
        jl, tl = js.decode(jk, jvalid, jsids), ts.decode(tk, tvalid, tsids)
        for sid in jl:
            assert len(jl[sid]) == len(tl[sid])
            for a, b in zip(jl[sid], tl[sid]):
                np.testing.assert_allclose(b.points, a.points, rtol=0,
                                           atol=atol)
            n_lanes += len(tl[sid])
    assert ts.memory.t == int(js.memory.t) == 11
    return n_lanes


def ol_clips(frame_shape, lengths=(5, 4)):
    """In-memory OL clips (the pipeline's duck-typed dataset) in OL's
    cropped coordinate frame."""
    out = []
    for i, t in enumerate(lengths):
        pts = [np.array([[500.0 + 80 * j, 790.0 - 60 * k] for k in range(4)])
               for j in range(2)]
        out.append({"frames": seeded_frames(40 + i, (t,) + frame_shape),
                    "size": OL_SIZE, "name": f"segment_{i}",
                    "frame_names": [f"{n:06d}" for n in range(t)],
                    "points": [pts] * t})
    return out


def lines_files(root):
    import os

    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def compare_pipelines(jpipe, tpipe, data, tmp_path):
    """Both pipelines over ``data``, emitted in the OL format: the same
    files, lane counts equal, points within 0.11 px (the format prints one
    decimal of half-scale pixels, so a 1e-5 difference can move the last
    digit), the ground-truth files byte-equal. Returns the lane count."""
    from phnet_torch.evaluation.emit import read_lines_txt

    out = {}
    for name, pipe in (("jax", jpipe), ("torch", tpipe)):
        out[name] = pipe.run_and_emit(data, str(tmp_path / f"{name}_pred"),
                                      str(tmp_path / f"{name}_anno"),
                                      fmt="ol")
    assert out["torch"]["frames"] == out["jax"]["frames"] == sum(
        len(c["frame_names"]) for c in data)
    files = lines_files(tmp_path / "jax_pred")
    assert files == lines_files(tmp_path / "torch_pred")
    assert len(files) == out["jax"]["frames"]
    n_lanes = 0
    for f in files:
        jl = read_lines_txt(str(tmp_path / "jax_pred" / f))
        tl = read_lines_txt(str(tmp_path / "torch_pred" / f))
        assert len(tl) == len(jl), f
        for a, b in zip(jl, tl):
            assert len(a) == len(b), f
            np.testing.assert_allclose(b, a, rtol=0, atol=0.11, err_msg=f)
        n_lanes += len(tl)
        assert ((tmp_path / "torch_anno" / f).read_bytes()
                == (tmp_path / "jax_anno" / f).read_bytes())
    return n_lanes


def pipelines(jc, tc, variables, chunk):
    """A function of a quantize mode giving (JAX pipeline, port pipeline)
    in chunks of ``chunk`` frames, each built once: a mode's JAX chunk
    compiles once for all the tests that use it."""
    import dataclasses

    from phnet_torch.config import Config as TorchConfig
    from phnet_torch.convert import convert
    from phnet_torch.pipeline import InferencePipeline as TorchPipeline
    from phnet_tpu.config import Config as JaxConfig
    from phnet_tpu.pipeline import InferencePipeline as JaxPipeline

    made = {}

    def get(mode):
        if mode not in made:
            made[mode] = (
                JaxPipeline(JaxConfig(model=dataclasses.replace(
                    jc, quantize=mode)), jax_tree(variables), chunk=chunk),
                TorchPipeline(TorchConfig(model=dataclasses.replace(
                    tc, quantize=mode)), convert(variables), chunk=chunk,
                    device="cpu"))
        return made[mode]

    return get


def run_chunk(pipes, frames):
    """One chunk of a clip ([1, T, H, W, 3]) through ``detect`` in both
    packages, the memory starting empty, by the pipelines' own chunk
    functions: {output name: (port, JAX)}; JAX's keep counts are its
    valid slots' sums."""
    from phnet_torch.models.phnet import init_memory as torch_init_memory
    from phnet_tpu.models.phnet import init_memory as jax_init_memory

    jpipe, tpipe = pipes
    jk, jv, jmem = jpipe._run_chunk(
        jpipe.variables, jnp.asarray(frames),
        jax_init_memory(jpipe.mcfg, 1, jpipe.memory_window))
    with torch.no_grad():
        tout, tmem = tpipe.model(
            torch.from_numpy(frames), dyn_combined=tpipe._dyn,
            initial_memory=torch_init_memory(tpipe.mcfg, 1,
                                             tpipe.memory_window))
    return {"kept": (tout.kept, jk), "kept_valid": (tout.kept_valid, jv),
            "num_kept": (tout.num_kept, jv.sum(-1)),
            "memory values": (tmem.values, jmem.values),
            "memory mask": (tmem.mask, jmem.mask)}


def check_clip_output(out, name, atol):
    """One output of :func:`run_chunk`: floats within ``atol``, the rest
    equal; lanes kept."""
    g, r = to_np(out[name][0]), np.asarray(out[name][1])
    assert g.shape == r.shape
    if g.dtype == np.float32:
        np.testing.assert_allclose(g, r, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(g, r)
    assert int(out["num_kept"][0].sum()) > 0
