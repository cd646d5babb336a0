"""OpenLane-V's single-scale head (the reference's ``Router4OL``) in the
port against the JAX package, on the small OL configuration of
``torch_parity.small_ol_cfg`` (96x192 frames, 32 priors, 24 offsets, the
OL lane layout, learned positions, a separate offset head, soft routing,
top_k 4, a window of 2 frames): the presets, the learned embedding, the
merged heads with their offset head, one head frame with memory, a clip
longer than the window through ``detect``, the quantized clips, the
server, the pipeline, the OL ``.lines.txt`` emitter and the parameter
bridge of the full-width preset; and the presets of all three OpenLane-V
heads.

Tolerances, and why: float32 outputs within 1e-4 and keep sets equal (the
two packages sum in other orders; ``tests/test_torch_serving.py``'s
bound). The quantized heads (w8, int8) are held by the self-perturbation
method of ``tests/test_torch_quant.py``: the two packages' f32
activations differ by ~1e-6 before each bf16 cast or int8 round, so rare
elements land one step apart. Perturbing the head's input features by
1e-6 relative moved the port's own outputs by up to 2.2e-2 (w8) and
2.9e-3 (int8), 2.8e-6 at the 90th percentile; the port against JAX
measured 1.6e-2 (w8) and 2.9e-3 (int8), 3.6e-7 at the 90th percentile:
every output within 1e-1, and 90% of them within 1e-4.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phnet_torch.config as tcfg
import phnet_tpu.config as jcfg
from phnet_torch.convert import convert, plan
from phnet_torch.evaluation.emit import write_pred_txt as torch_write
from phnet_torch.geometry import decode_kept_rows as torch_decode
from phnet_torch.models import PHNet as TorchPHNet
from phnet_torch.models.positional import AnchorPositionalEncoding
from phnet_torch.serving import StreamingServer as TorchServer
from phnet_tpu.evaluation.emit import write_pred_txt as jax_write
from phnet_tpu.geometry import decode_kept_rows as jax_decode
from phnet_tpu.models import PHNet as JaxPHNet
from phnet_tpu.models.head import LaneHead as JaxLaneHead
from phnet_tpu.models.positional import (
    AnchorPositionalEncoding as JaxPositions)
from phnet_tpu.serving import StreamingServer as JaxServer

import torch_parity as tp

B = 2
CHUNK = 3  # a clip chunk longer than the window (2)
SEED = 1  # weights that keep lanes at confidence 0.5
FRAME = (96, 192, 3)
HEAD_OUTPUTS = ("pred_fir", "pred_sec", "diff", "attn_feat")
CLIP_OUTPUTS = ("kept", "kept_valid", "num_kept", "memory values",
                "memory mask")
QUANT_ATOL, QUANT_P90 = 1e-1, 1e-4


@pytest.fixture(scope="module")
def setup():
    jc, tc = tp.small_ol_cfg(jcfg), tp.small_ol_cfg(tcfg)
    variables = tp.init_variables(jc, seed=SEED)
    return jc, tc, variables, tp.torch_model(tc, variables)


@pytest.mark.parametrize("preset", ["vil100_config", "openlane_config",
                                    "openlane_multiscale_config",
                                    "openlane_propagate_config"])
def test_preset_matches_jax(preset):
    """Every field the port's preset has equals the JAX preset's, but for
    the multi-scale preset's ``head.dyn_param_reduction``: the port's head
    reads it, so the preset states the 4 that the JAX package's head fixes
    in code (``phnet_tpu/models/head_ms.py``) beside its unread 8. Among
    them the compute dtype and the router chain's bf16 flag (None: the
    server decides), and the prior-propagation preset's
    ``propagate_priors`` and one-frame memory."""
    # the port's value where the JAX preset's field is not the one that runs
    read_here = ({"model.head.dyn_param_reduction": 4}
                 if preset == "openlane_multiscale_config" else {})
    got, ref = getattr(tcfg, preset)(), getattr(jcfg, preset)()
    tp.check_fields(got.model, ref.model, "model", read_here)
    assert (got.model.compute_dtype, got.model.head.router_chain_bf16) == (
        ref.model.compute_dtype, ref.model.head.router_chain_bf16)
    tp.check_fields(got.train.loss, ref.train.loss, "train.loss")
    assert got.model.head.attn_dim == ref.model.head.attn_dim


def test_learned_embedding(setup):
    """The learned [A, d] positions: the JAX module's output, the port's,
    and the head's, equal."""
    jc, _, variables, tm = setup
    emb = variables["params"]["frame"]["head"]["pos_encoding"]["embedding"]
    ref = JaxPositions(num_anchors=32, dim=16, kind="learned").apply(
        {"params": {"embedding": jnp.asarray(emb)}})
    mod = AnchorPositionalEncoding(32, 16, "learned")
    mod.load_state_dict({"embedding": torch.from_numpy(emb)})
    np.testing.assert_array_equal(tp.to_np(mod()), np.asarray(ref))
    np.testing.assert_array_equal(tp.to_np(tm.head.pos_encoding()),
                                  np.asarray(ref))


def jax_head(jc, variables, method, *args):
    params = tp.jax_tree(variables["params"]["frame"]["head"])
    return jax.jit(lambda p, *a: JaxLaneHead(jc).apply(
        {"params": p}, *a, method=method))(params, *args)


@pytest.fixture(scope="module")
def branches(setup):
    """Both branches' heads (cls, geometry, offsets) on random features:
    (full predictions, lines) of each branch, JAX and port."""
    jc, _, variables, tm = setup
    rng = np.random.default_rng(3)
    f_fir = rng.normal(size=(B, 32, 16)).astype(np.float32)
    f_sec = rng.normal(size=(B, 32, 32)).astype(np.float32)
    priors = np.broadcast_to(tp.to_np(tm.head.initial_priors()),
                             (B, 32, jc.lane.dim)).copy()
    ref = jax_head(jc, variables,
                   lambda m, a, b, p: m._dual_branch(a, b, p),
                   *map(jnp.asarray, (f_fir, f_sec, priors)))
    with torch.no_grad():
        got = tm.head._branches(*map(torch.from_numpy,
                                     (f_fir, f_sec, priors)))
    return got, ref


@pytest.mark.parametrize("branch", [0, 1], ids=["fir", "sec"])
@pytest.mark.parametrize("part", [0, 1], ids=["full", "lines"])
def test_separate_offset_heads(setup, branches, branch, part):
    """The merged heads emit (cls, geometry, offsets); the full
    predictions add the offsets to the line xs. Within 1e-4."""
    got, ref = branches
    g, r = tp.to_np(got[branch][part]), np.asarray(ref[branch][part])
    assert g.shape == r.shape == (B, 32, 6 + 24)
    np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
    assert setup[3].head.heads_fir.out_dims == (2, 4, 24)


def run_head(setup, mode="none"):
    """One head frame on injected FPN features and a memory bank with
    some valid slots (stream 1 none), JAX and port."""
    jc, tc, variables, tm = setup
    if mode != "none":
        jc = dataclasses.replace(jc, quantize=mode)
        tm = tp.torch_model(dataclasses.replace(tc, quantize=mode),
                            variables)
    rng = np.random.default_rng(2)
    shapes = [(B, 12, 24, 16), (B, 6, 12, 16), (B, 3, 6, 16)]
    feats = [rng.normal(size=s).astype(np.float32) for s in shapes]
    m, d = 2 * 5, jc.head.attn_dim
    mem_vals = rng.normal(size=(B, 3, m, d)).astype(np.float32)
    mem_mask = rng.uniform(size=(B, m)) < 0.5
    mem_mask[1] = False
    ref = jax_head(jc, variables, lambda mdl, f, v, mk: mdl(
        f, v, mk, train=False), tuple(map(jnp.asarray, feats)),
        jnp.asarray(mem_vals), jnp.asarray(mem_mask))
    with torch.no_grad():
        got = tm.head(tuple(map(torch.from_numpy, feats)),
                      torch.from_numpy(mem_vals), torch.from_numpy(mem_mask))
    return got, ref


@pytest.fixture(scope="module")
def head_frame(setup):
    return run_head(setup)


@pytest.mark.parametrize("name", HEAD_OUTPUTS)
def test_head_one_frame_with_memory(head_frame, name):
    got, ref = head_frame
    g, r = tp.to_np(getattr(got, name)), np.asarray(getattr(ref, name))
    assert g.shape == r.shape
    np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["w8", "int8"])
def test_quantized_head_matches_jax(setup, mode):
    """The head frame with quantized DynamicConv chains: every output
    within 1e-1 and 90% of them within 1e-4 (see the module
    docstring)."""
    got, ref = run_head(setup, mode)
    for name in HEAD_OUTPUTS:
        g, r = tp.to_np(getattr(got, name)), np.asarray(getattr(ref, name))
        np.testing.assert_allclose(g, r, rtol=0, atol=QUANT_ATOL,
                                   err_msg=name)
        assert np.percentile(np.abs(g - r), 90) <= QUANT_P90, name


@pytest.fixture(scope="module")
def pipelines(setup):
    jc, tc, variables, _ = setup
    return tp.pipelines(jc, tc, variables, CHUNK)


@pytest.fixture(scope="module")
def clip(pipelines):
    out = tp.run_chunk(pipelines("none"), tp.seeded_frames(1, (1, CHUNK)
                                                         + FRAME))
    assert out["memory values"][0].shape[2] == 2  # the window: it wraps
    return out


@pytest.mark.parametrize("name", CLIP_OUTPUTS)
def test_clip_through_detect(clip, name):
    """A clip of 3 frames (longer than the window of 2) through
    ``detect``: kept rows and memory values within 1e-4, the rest equal;
    lanes kept."""
    tp.check_clip_output(clip, name, 1e-4)


def test_server_matches_jax(setup):
    """Two streams through both servers with the window of 2 frames from
    the config: a skipped tick, detach and attach, a weight swap, eleven
    ticks (the ring wraps five times)."""
    jc, tc, variables, _ = setup
    js = JaxServer(jcfg.Config(model=jc), tp.jax_tree(variables),
                   max_streams=2)
    ts = TorchServer(tcfg.Config(model=tc), convert(variables),
                     max_streams=2, device="cpu")
    assert ts.window == js.window == 2
    swap = tp.init_variables(jc, seed=SEED + 4)
    assert tp.drive_servers(js, ts, swap, FRAME) > 0


def test_pipeline_matches_jax(pipelines, tmp_path):
    """Clips of 5 and 4 frames in chunks of 3 (each chunk crosses the
    window of 2; the memory is carried across chunks; the last chunk is
    padded), emitted in the OL format."""
    jpipe, tpipe = pipelines("none")
    assert tpipe.memory_window == jpipe.memory_window == 2
    assert tp.compare_pipelines(jpipe, tpipe, tp.ol_clips(FRAME),
                                tmp_path) > 0


def test_pipeline_emits_in_config_geometry(setup, pipelines, tmp_path):
    """The emission reads the config's geometry. OL: a clip without its
    own ``size`` is emitted in ``org_size`` less ``crop_size`` rows (the
    same bytes as with OL's frame given), and a crop of 400 rows in place
    of 480 moves every emitted y by -40 half-scale px, x unchanged. VIL: a
    clip without its ``cut`` has a cut of 0, as the JAX pipeline reads
    it."""
    from phnet_torch.evaluation.emit import read_lines_txt
    from phnet_torch.pipeline import InferencePipeline as TorchPipeline

    _, tc, variables, _ = setup
    _, base = pipelines("none")
    crop400 = TorchPipeline(tcfg.Config(model=dataclasses.replace(
        tc, crop_size=400)), convert(variables), chunk=CHUNK, device="cpu")
    clips = tp.ol_clips(FRAME, lengths=(3,))
    sizeless = [{k: v for k, v in c.items() if k != "size"} for c in clips]
    out = {}
    for name, pipe, data in (("given", base, clips),
                             ("sizeless", base, sizeless),
                             ("crop400", crop400, clips)):
        pipe.run_and_emit(data, str(tmp_path / name), fmt="ol")
        out[name] = {f: read_lines_txt(str(tmp_path / name / f))
                     for f in tp.lines_files(tmp_path / name)}
        assert name == "given" or set(out[name]) == set(out["given"])
    n_lanes = 0
    for f in out["given"]:
        assert ((tmp_path / "sizeless" / f).read_bytes()
                == (tmp_path / "given" / f).read_bytes())
        assert len(out["crop400"][f]) == len(out["given"][f])
        for a, b in zip(out["given"][f], out["crop400"][f]):
            a, b = np.asarray(a), np.asarray(b)
            np.testing.assert_array_equal(b[:, 0], a[:, 0])
            np.testing.assert_allclose(b[:, 1], a[:, 1] - 40.0, rtol=0,
                                       atol=0.11)
            n_lanes += 1
    assert n_lanes > 0
    assert base._clip_geometry({"size": (720, 1280)}, "vil") == (
        (720, 1280), 720, 0)
    assert base._clip_geometry({"size": (720, 1280), "cut": 100},
                               "vil") == ((720, 1280), 720, 100)


@pytest.mark.parametrize("seed", range(4))
def test_ol_lines_byte_equal(seed, tmp_path):
    """Kept OL rows at 72 offsets decoded (extended to the image bottom)
    and emitted at OL's crop (480 rows) of its 1280x1920 images by both
    packages: the ``.lines.txt`` files byte-equal."""
    spec_t, spec_j = tcfg.openlane_config().model.lane, \
        jcfg.openlane_config().model.lane
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(4, spec_t.dim)).astype(np.float32)
    rows[:, spec_t.col_start_y] = rng.uniform(0.0, 0.5, 4)
    rows[:, spec_t.col_length] = rng.uniform(0.2, 1.0, 4)
    rows[:, spec_t.col_xs:] = (rng.uniform(0.2, 0.8, (4, 1))
                               + np.linspace(-0.3, 0.3, spec_t.n_offsets)
                               * rng.uniform(-1, 1, (4, 1)))
    crop = tcfg.openlane_config().model.crop_size
    org = tcfg.openlane_config().model.org_size
    size = (org[0] - crop, org[1])
    assert size == tp.OL_SIZE
    paths = []
    for name, decode, write, spec in (("t", torch_decode, torch_write, spec_t),
                                      ("j", jax_decode, jax_write, spec_j)):
        lanes = decode(rows, spec)
        paths.append(write(str(tmp_path / name), "seg", "000001", lanes,
                           size, fmt="ol", crop_offset=crop))
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1] and data[0].count(b"\n") >= 2


def test_convert_round_trip():
    """The full-width preset: every JAX leaf maps once onto the port's
    state_dict, shapes equal."""
    cfg = jcfg.openlane_config().model
    model = JaxPHNet(cfg)
    frames = jax.ShapeDtypeStruct((1, 2, cfg.img_h, cfg.img_w, 3),
                                  jnp.float32)
    shapes = jax.eval_shape(lambda f: model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, f,
        None, train=False), frames)
    mapping = plan(shapes)
    leaves = jax.tree_util.tree_leaves(shapes)
    assert len(mapping) == len(leaves) == 252
    assert sum(math.prod(x.shape) for x in leaves) == 83_559_791
    sd = {k: tuple(v.shape) for k, v in TorchPHNet(
        tcfg.openlane_config().model, device="meta").state_dict().items()}
    assert set(mapping) == set(sd)
    for key, (path, shape) in mapping.items():
        assert shape == sd[key], (path, shape, sd[key])
    assert mapping["head.pos_encoding.embedding"][1] == (240, 64)
    assert mapping["head.heads_sec.out2_kernel"][1] == (128, 72)
