"""Deployment artifacts of the port (``phnet_torch.export``) on the CPU, at
the small geometry of ``torch_parity``.

- the port's artifact against the JAX package's server: batch 2, window 4,
  the weights of ``tp.init_variables`` through ``convert``, four ticks:
  valid slots equal, kept rows within 1e-4 (``test_torch_serving.py``'s
  bound), the memory mask equal, decoded lanes within 1e-5 with
  per-stream geometry, ``t`` counting and ``reset``;
- the artifact against the port's live ``StreamingServer``, bit for bit,
  for the ring (VIL, wrapping), OpenLane-V's single-length layout
  (``Router4OL``, one stream ticked with single frames), the one-frame
  carry (``Router4OLV3``), ``quantize`` w8 (made through the command line
  from a port checkpoint) and int8, and bfloat16 compute; in each, the
  graph holds the ``phnet::`` operators the live tick calls, as often;
- the artifact's files and weights, the isolation of ``DeployedServer``
  from ``phnet_torch.models``, the refusal of a CUDA artifact without a
  card, and ``torch.library.opcheck`` of every operator.

One JAX compile (the JAX server's step); every export is of a small
model on the CPU.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
import phnet_torch.config as tcfg
import phnet_tpu.config as jcfg
from phnet_torch.convert import convert
from phnet_torch.export import DeployedServer, export_serving_step
from phnet_torch.ops.nms import nms_proposals_from_predictions
from phnet_torch.run import export_model
from phnet_torch.serving import StreamingServer as TorchServer
from phnet_tpu.serving import StreamingServer as JaxServer

import torch_parity as tp

WINDOW = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("nms_keeps", "lane_nms", "router_chain", "w8_matmul")


@pytest.fixture(scope="module")
def vil(tmp_path_factory):
    """The small VIL model's artifact, batch 2, window 4, with the weights
    of ``tp.init_variables``: (variables, state dict, artifact dir)."""
    variables = tp.init_variables(tp.jax_cfg(), seed=1)
    state_dict = convert(variables)
    art = str(tmp_path_factory.mktemp("vil"))
    export_serving_step(tp.torch_cfg(), state_dict, art, batch=2,
                        memory_window=WINDOW, device="cpu")
    return variables, state_dict, art


def test_artifact_matches_jax_server(vil):
    variables, _, art = vil
    js = JaxServer(jcfg.Config(model=tp.jax_cfg()), tp.jax_tree(variables),
                   max_streams=2, memory_window=WINDOW)
    geos = [(720, 252), (1080, 378)]
    sids = [js.attach(ori_img_h=h, cut_height=c) for h, c in geos]
    dep = DeployedServer(art)
    assert dep.manifest["memory_class"] == "MemoryState"
    n_lanes = 0
    for tick in range(4):
        frames = np.stack([tp.seeded_frames(10 * s + tick, (64, 128, 3))
                           for s in range(2)])
        kept, valid = dep.tick(frames)
        jk, jvalid, jsids = js.step_async({s: frames[s] for s in sids})
        assert kept.shape == (2, 4, 19)
        np.testing.assert_array_equal(valid, np.asarray(jvalid))
        np.testing.assert_allclose(kept, np.asarray(jk), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tp.to_np(dep.memory[1]),
                                      np.asarray(js.memory.mask))
        lanes = dep.decode(kept, valid, ori_img_h=[g[0] for g in geos],
                           cut_height=[g[1] for g in geos])
        jlanes = js.decode(jk, jvalid, jsids)
        for s in sids:
            assert len(lanes[s]) == len(jlanes[s])
            for a, b in zip(lanes[s], jlanes[s]):
                np.testing.assert_allclose(a.points, b.points, rtol=0,
                                           atol=1e-5)
            n_lanes += len(lanes[s])
    assert n_lanes > 0
    assert int(dep.memory[-1]) == int(js.memory.t) == 4
    dep.reset()
    assert int(dep.memory[-1]) == 0


class OpCount(TorchDispatchMode):
    """Counts the ``phnet::`` operators called under it."""

    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "phnet":
            self.counts[func.__name__.split(".")[0]] += 1
        return func(*args, **(kwargs or {}))


def graph_ops(dep: DeployedServer) -> Counter:
    return Counter(str(n.target).split(".")[1] for n in dep.graph.nodes
                   if str(n.target).startswith("phnet."))


def seeded_state_dict(cfg, seed):
    return chip_smoke.seeded_state_dict(torch, tcfg.Config(model=cfg), seed)


def check_against_live(dep, cfg, state_dict, batch, window, ticks=3,
                       single=False):
    """``ticks`` ticks of ``dep`` and of a live server on the same frames:
    kept rows, valid slots and every memory leaf bit-equal; the graph
    holds each ``phnet::`` operator as often as the live tick calls it.
    Returns the kept lanes."""
    live = TorchServer(tcfg.Config(model=cfg), state_dict, max_streams=batch,
                       memory_window=window, device="cpu")
    sids = [live.attach() for _ in range(batch)]
    shape = (cfg.img_h, cfg.img_w, 3)
    n_kept = 0
    for tick in range(ticks):
        frames = np.stack([tp.seeded_frames(100 * s + tick, shape)
                           for s in sids])
        kept, valid = dep.tick(frames[0] if single else frames)
        with OpCount() as count:
            lk, lvalid, _ = live.step_async({s: frames[s] for s in sids})
        np.testing.assert_array_equal(valid, tp.to_np(lvalid))
        np.testing.assert_array_equal(kept, tp.to_np(lk))
        mem = live.memory
        for got, want in zip(dep.memory[:-1], mem[:-1]):
            assert torch.equal(got, want)
        assert int(dep.memory[-1]) == mem.t == tick + 1
        n_kept += int(valid.sum())
    assert graph_ops(dep) == count.counts
    return n_kept


CASES = {  # name: (config, batch, window, seed of the weights)
    "single_length": (tp.small_ol_cfg(tcfg), 1, None, 0),
    "carry": (tp.small_v3_cfg(tcfg), 2, None, 0),
    "int8": (dataclasses.replace(tp.torch_cfg(), quantize="int8"), 2,
             WINDOW, 0),
    "bf16": (dataclasses.replace(tp.torch_cfg(), compute_dtype="bfloat16"),
             2, WINDOW, 0),
}


def test_ring_matches_live_server(vil):
    """The ring (window 4, wrapping on the fifth tick) with the weights of
    ``tp.init_variables``: one lane NMS and one router chain a refine
    stage, no w8 product."""
    _, state_dict, art = vil
    dep = DeployedServer(art)
    assert check_against_live(dep, tp.torch_cfg(), state_dict, 2, WINDOW,
                              ticks=WINDOW + 1) > 0
    assert graph_ops(dep) == {"nms_keeps": 1, "router_chain": 3}


@pytest.mark.parametrize("case", sorted(CASES))
def test_artifact_matches_live_server(case, tmp_path):
    cfg, batch, window, seed = CASES[case]
    state_dict = seeded_state_dict(cfg, seed)
    export_serving_step(cfg, state_dict, str(tmp_path), batch=batch,
                        memory_window=window, device="cpu")
    dep = DeployedServer(str(tmp_path))
    assert dep.manifest["compute_dtype"] == cfg.compute_dtype
    assert dep.manifest["quantize"] == cfg.quantize
    want_window = window or cfg.memory.window
    assert dep.manifest["memory_window"] == want_window
    assert check_against_live(dep, cfg, state_dict, batch, want_window,
                              single=batch == 1) > 0
    if case == "carry":
        assert dep.manifest["memory_class"] == "V3MemoryState"
        assert graph_ops(dep) == {"nms_keeps": 1}
    if case == "single_length":
        assert dep.manifest["lane_spec"]["n_lengths"] == 1


def test_command_line_w8_artifact(tmp_path):
    """``python -m phnet_torch.run.export_model --quantize w8`` from a port
    checkpoint: the artifact equals the live w8 server bit for bit, and
    its graph holds a w8 product for each of the live tick's (12: four a
    refine stage)."""
    cfg = tp.torch_cfg()
    state_dict = seeded_state_dict(cfg, 0)
    ckpt = chip_smoke.write_port_checkpoint(
        torch, tcfg.Config(model=cfg), state_dict, str(tmp_path / "run"))
    art = str(tmp_path / "art")
    export_model.main(["--checkpoint", ckpt, "--out", art, "--device", "cpu",
                       "--batch", "2", "--window", str(WINDOW),
                       "--quantize", "w8"], cfg=tcfg.Config(model=cfg))
    dep = DeployedServer(art)
    assert dep.manifest["quantize"] == "w8"
    assert not dep.manifest["router_chain_bf16"]
    w8 = dataclasses.replace(cfg, quantize="w8")
    assert check_against_live(dep, w8, state_dict, 2, WINDOW) > 0
    assert graph_ops(dep) == {"nms_keeps": 1, "router_chain": 3,
                              "w8_matmul": 12}


def test_artifact_files_and_weights(vil):
    _, state_dict, art = vil
    assert sorted(os.listdir(art)) == ["manifest.json", "memory.npz",
                                       "params.npz", "step.pt2"]
    with np.load(os.path.join(art, "params.npz")) as z:
        assert sorted(z.files) == sorted(state_dict)
        for k, v in state_dict.items():
            got = z[k]
            assert got.dtype == tp.to_np(v).dtype, k
            np.testing.assert_array_equal(got, tp.to_np(v), err_msg=k)
    with np.load(os.path.join(art, "memory.npz")) as z:
        assert sorted(z.files) == ["m0", "m1", "m2"]
        assert z["m2"].dtype == np.int32 and int(z["m2"]) == 0
        head = tp.torch_cfg().head
        assert z["m0"].shape == (2, head.refine_layers, WINDOW, 5,
                                 head.attn_dim)
        assert not z["m1"].any()
    with open(os.path.join(art, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["kind"] == "serving_step"
    assert manifest["device"] == "cpu" and manifest["packed"] is None
    assert (manifest["batch"], manifest["memory_window"]) == (2, WINDOW)
    assert (manifest["img_h"], manifest["img_w"]) == (64, 128)
    assert manifest["frames_dtype"] == "float32"
    assert manifest["lane_spec"] == {"n_offsets": 12, "n_lengths": 2}
    assert manifest["max_lanes"] == 4
    assert manifest["torch_version"] == torch.__version__


def test_deployed_server_does_not_import_the_models(vil):
    _, _, art = vil
    script = (
        "import json, sys\n"
        "import numpy as np\n"
        "from phnet_torch.export import DeployedServer\n"
        f"dep = DeployedServer({art!r})\n"
        "kept, valid = dep.tick(np.zeros((2, 64, 128, 3), np.float32))\n"
        "assert kept.shape == (2, 4, 19)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.startswith('phnet'))))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    run = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    modules = json.loads(run.stdout.strip().splitlines()[-1])
    assert "phnet_torch.export" in modules and "phnet_torch.ops" in modules
    assert not [m for m in modules if m == "phnet_torch.models"
                or m.startswith("phnet_torch.models.")], modules
    assert not [m for m in modules if m.startswith("phnet_tpu")], modules


def test_cuda_artifact_raises_without_a_card(vil, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: a CUDA artifact loads")
    _, _, art = vil
    copy = str(tmp_path / "art")
    shutil.copytree(art, copy)
    path = os.path.join(copy, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["device"] = "cuda"
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeployedServer(copy)


def op_inputs(name):
    """Small seeded arguments of the operator ``phnet::<name>``."""
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    spec = tcfg.LaneSpec(n_offsets=12, n_lengths=2)
    routed = normal(2, 32, spec.dim)
    routed[..., 5] = routed[..., 5].abs() * 0.5
    scores = torch.softmax(routed[..., :2], dim=-1)[..., 1]
    if name == "nms_keeps":
        return (routed, scores, spec.col_start_y, spec.col_length,
                spec.col_xs, spec.n_offsets, 127.0, float(spec.n_strips),
                0.3, 20.0, 4)
    if name == "lane_nms":
        props = nms_proposals_from_predictions(routed, spec, 128)
        return props, scores.contiguous(), scores >= 0.3, 20.0, 12, 4
    if name in ("router_chain", "router_chain_bf16"):
        return (normal(8, 16, 8), normal(4, 36), normal(4, 4),
                normal(10, 16, 8), 2, name == "router_chain_bf16")
    wq = torch.from_numpy(rng.integers(-127, 128, (64, 16)).astype(np.int8))
    return normal(3, 5, 64), wq, normal(16).abs()


@pytest.mark.parametrize("name", ["nms_keeps", "lane_nms", "router_chain",
                                  "router_chain_bf16", "w8_matmul"])
def test_operator_opcheck(name):
    """Schema, fake implementation, autograd registration and AOT dispatch
    of each ``phnet::`` operator (the router chain in both modes)."""
    op = getattr(torch.ops.phnet, name.replace("_bf16", "")).default
    torch.library.opcheck(op, op_inputs(name))


def test_operators_registered():
    for name in OPS:
        assert hasattr(torch.ops.phnet, name), name
