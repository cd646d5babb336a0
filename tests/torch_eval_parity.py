"""Shared set-up of the evaluation-path parity tests
(``test_torch_eval_*.py``): the committed fixture
(``tests/fixtures/torch_eval``, written by
``tools/make_torch_eval_fixture.py``), the small configurations of
``tests/torch_parity.py`` (the port's readers take their frame size, cut
and crop from the model configuration; the JAX readers from a
``DataConfig`` reading the fixture at that size), and helpers over
emitted ``.lines.txt`` trees."""

import os
from pathlib import Path

import numpy as np

from phnet_torch.convert import convert
from phnet_torch.train.checkpoint import CheckpointManager
from phnet_torch.train.state import create_train_state

import torch_parity as tp

REPO = Path(__file__).resolve().parents[1]
FIXTURE = str(REPO / "tests" / "fixtures" / "torch_eval")
CHUNK = 3


def small_vil(cfgmod):
    return cfgmod.Config(model=tp.small_model_cfg(cfgmod))


def small_ol(cfgmod):
    return cfgmod.Config(model=tp.small_ol_cfg(cfgmod))


def jax_data(jcfg, model, dataset="VIL100"):
    """The JAX readers' ``DataConfig`` of the fixture for ``model`` (a JAX
    ``ModelConfig``): its frame size, cut or crop and label rows."""
    return jcfg.DataConfig(
        root=FIXTURE, dataset=dataset, img_h=model.img_h, img_w=model.img_w,
        cut_scale=model.cut_scale, crop_size=model.crop_size,
        max_lanes=model.max_lanes)


def write_checkpoint(cfg, variables, workdir) -> str:
    """The bridged weights as a ``phnet_torch.train`` checkpoint; returns
    the ``--checkpoint`` argument."""
    state = create_train_state(cfg, 1, device="cpu")
    state.model.load_state_dict(convert(variables), strict=True)
    CheckpointManager(str(workdir)).save(state, epoch=0, max_skip=0,
                                         is_best=True, periodic=False)
    return os.path.join(str(workdir), "best")


def files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_trees_byte_equal(a, b):
    names = files(a)
    assert names == files(b) and names
    for f in names:
        assert (Path(b) / f).read_bytes() == (Path(a) / f).read_bytes(), f


def lane_count(root):
    return sum(len([l for l in (Path(root) / f).read_text().splitlines()
                    if l.strip()]) for f in files(root))


def reference_state_dict(variables, stage_blocks=(2, 2, 2, 2)):
    """The JAX ``variables`` tree exported under the reference's
    ``RouterWithB`` key names and layouts (the inverse of
    ``phnet_tpu.utils.torch_import.load_reference_checkpoint``), with two
    keys the model has no use for."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}

    def put(key, x):
        sd[key] = np.ascontiguousarray(x, dtype=np.float32)

    def conv(key, kernel):  # HWIO -> OIHW
        put(key, np.transpose(kernel, (3, 2, 0, 1)))

    def linear(key, node):
        put(key + ".weight", np.transpose(node["kernel"]))
        put(key + ".bias", node["bias"])

    def norm(key, node, stat=None):
        put(key + ".weight", node["scale"])
        put(key + ".bias", node["bias"])
        if stat is not None:
            put(key + ".running_mean", stat["mean"])
            put(key + ".running_var", stat["var"])

    bb, pre = params["encoder"]["backbone"], "backbone.backbone.model."
    bs = stats["encoder"]["backbone"]

    def bn(key, scope, name):
        norm(key, bb[scope][name]["BatchNorm_0"],
             bs[scope][name]["BatchNorm_0"])

    conv(pre + "conv1.weight", bb["Conv_0"]["kernel"])
    norm(pre + "bn1", bb["Norm_0"]["BatchNorm_0"], bs["Norm_0"]["BatchNorm_0"])
    idx = 0
    for stage, n in enumerate(stage_blocks):
        for b in range(n):
            scope, t = f"BasicBlock_{idx}", f"{pre}layer{stage + 1}.{b}."
            blk = bb[scope]
            conv(t + "conv1.weight", blk["Conv_0"]["kernel"])
            conv(t + "conv2.weight", blk["Conv_1"]["kernel"])
            bn(t + "bn1", scope, "Norm_0")
            bn(t + "bn2", scope, "Norm_1")
            if "Conv_2" in blk:
                conv(t + "downsample.0.weight", blk["Conv_2"]["kernel"])
                bn(t + "downsample.1", scope, "Norm_2")
            idx += 1
    sd[pre + "fc.weight"] = np.zeros((10, 4), np.float32)  # unused
    sd[pre + "bn1.num_batches_tracked"] = np.zeros((), np.int64)  # unused

    neck = params["encoder"]["neck"]
    for i in range(3):
        for ours, theirs in (("lateral", "lateral_convs"),
                             ("fpn", "fpn_convs")):
            conv(f"backbone.neck.{theirs}.{i}.conv.weight",
                 neck[f"{ours}_{i}"]["kernel"])
            put(f"backbone.neck.{theirs}.{i}.conv.bias",
                neck[f"{ours}_{i}"]["bias"])

    head, d = params["frame"]["head"], "detNet."
    put(d + "prior_embeddings.weight", head["prior_embeddings"])
    put(d + "pro_embedding.weight", head["pro_embedding"])
    if "pos_encoding" in head:
        put(d + "PositionEmbedding.embed.weight",
            head["pos_encoding"]["embedding"])
    n_stacks = np.shape(head["heads_fir"]["fc0_kernel"])[0]
    stacks = ("cls", "reg", "iou")[:n_stacks]
    for branch, suffix in (("heads_fir", ""), ("heads_sec", "_sec")):
        hp = head[branch]
        for i in range(2):
            for j, m in enumerate(stacks):
                put(f"{d}{m}_modules{suffix}.{2 * i}.weight",
                    np.transpose(np.asarray(hp[f"fc{i}_kernel"])[j]))
                put(f"{d}{m}_modules{suffix}.{2 * i}.bias",
                    np.asarray(hp[f"fc{i}_bias"])[j])
        for j, m in enumerate(stacks):
            put(f"{d}{m}_layers{suffix}.weight",
                np.transpose(hp[f"out{j}_kernel"]))
            put(f"{d}{m}_layers{suffix}.bias", hp[f"out{j}_bias"])
    s = 0
    while f"dyn_head_{s}" in head:
        dp, p = head[f"dyn_head_{s}"], f"{d}DHead_series.{s}."
        for ours, theirs in (("gen1_a", "dynamic_layer_1.0"),
                             ("gen1_b", "dynamic_layer_1.1"),
                             ("gen2_a", "dynamic_layer_2.0"),
                             ("gen2_b", "dynamic_layer_2.1"),
                             ("out_a", "out_layer.0"),
                             ("out_b", "out_layer.1")):
            linear(p + theirs, dp[ours])
        for n in ("norm1", "norm2", "norm3"):
            norm(p + n, dp[n])
        rp = head[f"router_{s}"]
        taps, cbias = np.asarray(rp["taps"]), np.asarray(rp["conv_bias"])
        lnp = np.asarray(rp["ln_params"])
        put(f"{d}router.pre_norm.{s}.weight", lnp[0])
        put(f"{d}router.pre_norm.{s}.bias", lnp[1])
        for b in range(taps.shape[1] // 18):
            base, o = f"{d}router.DWNets.{s}.{b}.", 2 + 4 * b
            for k, (first, col) in enumerate((("0", 0), ("3", 1))):
                cols = slice(18 * b + 9 * k, 18 * b + 9 * (k + 1))
                put(base + first + ".weight",
                    taps[:, cols].reshape(-1, 1, 3, 3))
                put(base + first + ".bias", cbias[:, 2 * b + col])
            put(base + "1.weight", lnp[o])
            put(base + "1.bias", lnp[o + 1])
            put(base + "4.weight", lnp[o + 2])
            put(base + "4.bias", lnp[o + 3])
        linear(f"{d}router.layers.{s}.0", rp["Dense_0"])
        linear(f"{d}router.layers.{s}.2", rp["Dense_1"])
        s += 1
    td = head["temporal_decoder"]
    i = 0
    while f"layer{i}" in td:
        lp, p = td[f"layer{i}"], f"{d}transformer_Dec.layers.{i}."
        linear(p + "self_attn.in_proj", lp["self_attn"]["qkv"])
        sd[p + "self_attn.in_proj_weight"] = sd.pop(
            p + "self_attn.in_proj.weight")
        sd[p + "self_attn.in_proj_bias"] = sd.pop(p + "self_attn.in_proj.bias")
        linear(p + "self_attn.out_proj", lp["self_attn"]["out"])
        ca = lp["cross_attn"]
        put(p + "multihead_attn.in_proj_weight", np.concatenate(
            [np.transpose(ca["q"]["kernel"]),
             np.transpose(ca["kv"]["kernel"])]))
        put(p + "multihead_attn.in_proj_bias", np.concatenate(
            [ca["q"]["bias"], ca["kv"]["bias"]]))
        linear(p + "multihead_attn.out_proj", ca["out"])
        linear(p + "linear1", lp["ffn1"])
        linear(p + "linear2", lp["ffn2"])
        for n in ("norm1", "norm2", "norm3"):
            norm(p + n, lp[n])
        i += 1
    norm(d + "transformer_Dec.norm", td["final_norm"])
    return sd
