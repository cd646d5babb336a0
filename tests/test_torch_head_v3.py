"""OpenLane-V's prior-propagation head (the reference's ``Router4OLV3``) in
the port against the JAX package, on the small configuration of
``torch_parity.small_v3_cfg`` (``tests/test_head_v3.py::v3_cfg``: 96x192
frames, 32 priors, 12 offsets, K = 4 propagated slots, a one-frame carry;
weights whose keeps vary from 1 to 4 a frame and reach the propagated
rows): the parameter bridge of the full-width preset, the head on an
empty and on a partly valid carry, its dead rows, the K-row decoder's
``tgt_mask``, a clip through ``detect``, the server, the pipeline, the
w8 head and a bf16 clip.

Tolerances, and why. Float32: outputs and carry within 1e-4, keep sets
equal (the packages sum in other orders; measured 5.7e-5 on the head, the
clip's kept rows 3.9e-6, its carry 5.7e-6). Dead rows: bit-equal, to the
dead row and to each other. w8: ``tests/test_torch_openlane.py``'s
self-perturbation bounds (every output within 1e-1, 90% of them within
1e-4; measured 3.3e-2 and 2.0e-6). bf16: the one-ulp method
of ``tests/test_torch_bf16.py`` on the clip (keep counts and kept rows on
the slots that one-ulp copies of the frames leave fixed in both packages,
the carry's features on the streams whose slots are all robust).
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
from phnet_torch.models import PHNet as TorchPHNet
from phnet_torch.models.phnet import init_memory as torch_init_memory
from phnet_torch.models.transformer import TemporalDecoder
from phnet_torch.serving import StreamingServer as TorchServer
from phnet_tpu.models import PHNet as JaxPHNet
from phnet_tpu.models.head_v3 import PropagatingLaneHead as JaxHead
from phnet_tpu.models.phnet import init_memory as jax_init_memory
from phnet_tpu.serving import StreamingServer as JaxServer

import test_torch_bf16 as tb
import torch_parity as tp

B = 2
K = 4
A = 32
CHUNK = 3
SEED = 2  # weights whose keeps vary (1 to 4 a frame) at confidence 0.5
FRAME = (96, 192, 3)
HEAD_OUTPUTS = ("pred_fir", "pred_sec", "diff", "query_feat")
CARRY = ("feat", "priors", "mask")
QUANT_ATOL, QUANT_P90 = 1e-1, 1e-4


@pytest.fixture(scope="module")
def setup():
    jc, tc = tp.small_v3_cfg(jcfg), tp.small_v3_cfg(tcfg)
    variables = tp.init_variables(jc, seed=SEED)
    return jc, tc, variables, tp.torch_model(tc, variables)


def test_convert_round_trip():
    """The full-width preset: every JAX leaf maps once onto the port's
    state_dict, shapes equal; the "_last" stacks and the MLP routers are
    there, and no router chain (the JAX head creates none)."""
    cfg = jcfg.openlane_propagate_config().model
    model = JaxPHNet(cfg)
    frames = jax.ShapeDtypeStruct((1, 2, cfg.img_h, cfg.img_w, 3),
                                  jnp.float32)
    shapes = jax.eval_shape(lambda f: model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, f,
        None, train=False), frames)
    mapping = plan(shapes)
    leaves = jax.tree_util.tree_leaves(shapes)
    assert len(mapping) == len(leaves)
    sd = {k: tuple(v.shape) for k, v in TorchPHNet(
        tcfg.openlane_propagate_config().model,
        device="meta").state_dict().items()}
    assert set(mapping) == set(sd)
    for key, (path, shape) in mapping.items():
        assert shape == sd[key], (path, shape, sd[key])
    head = {path[3] for path, _ in mapping.values() if path[:3] == (
        "params", "frame", "head")}
    assert head == {"dyn_head_0", "dyn_head_1", "dyn_head_2", "heads_fir",
                    "heads_fir_last", "heads_sec", "heads_sec_last",
                    "mlp_router_0", "mlp_router_1", "mlp_router_2",
                    "pos_encoding", "prior_embeddings", "pro_embedding",
                    "temporal_decoder", "temporal_decoder_last"}
    assert mapping["head.mlp_routers.1.fc1.weight"][1] == (32, 128)
    assert mapping["head.heads_fir_last.fc0_kernel"][1] == (3, 64, 64)
    assert sum(math.prod(x.shape) for x in leaves) == sum(
        math.prod(s) for s in sd.values())


def carry(kind):
    """A carry of frame t-1 for B streams: empty, or partly valid (stream
    0 slots 0 and 2, stream 1 none) with random features and priors."""
    rng = np.random.default_rng(4)
    feat = rng.normal(size=(B, 3, K, 32)).astype(np.float32)
    priors = (rng.normal(size=(B, K, 18)) * 0.1).astype(np.float32)
    priors[..., 6:] = rng.uniform(0.2, 0.8, (B, K, 12))
    valid = np.zeros((B, K), bool)
    if kind == "partial":
        valid[0, [0, 2]] = True
    else:
        feat[:], priors[:] = 0.0, 0.0
    return feat, priors, valid


_JAX_HEADS = {}


def run_head(setup, kind, mode="none"):
    """One head frame on injected FPN features and a carry, JAX and
    port."""
    jc, tc, variables, tm = setup
    if mode != "none":
        jc = dataclasses.replace(jc, quantize=mode)
        tm = tp.torch_model(dataclasses.replace(tc, quantize=mode),
                            variables)
    rng = np.random.default_rng(2)
    feats = [rng.normal(size=s).astype(np.float32) for s in (
        (B, 12, 24, 16), (B, 6, 12, 16), (B, 3, 6, 16))]
    mem = carry(kind)
    params = tp.jax_tree(variables["params"]["frame"]["head"])
    if mode not in _JAX_HEADS:  # one compile a mode
        _JAX_HEADS[mode] = jax.jit(
            lambda p, *a: JaxHead(jc).apply({"params": p}, *a))
    ref = _JAX_HEADS[mode](params, tuple(map(jnp.asarray, feats)),
                           *map(jnp.asarray, mem))
    with torch.no_grad():
        got = tm.head(tuple(map(torch.from_numpy, feats)),
                      *map(torch.from_numpy, mem))
    return got, ref


@pytest.fixture(scope="module")
def head_frames(setup):
    return {kind: run_head(setup, kind) for kind in ("empty", "partial")}


@pytest.mark.parametrize("name", HEAD_OUTPUTS)
@pytest.mark.parametrize("kind", ["empty", "partial"])
def test_head_matches_jax(head_frames, kind, name):
    """Every per-stage output over the A + K rows within 1e-4: frame 0
    (an empty carry) and a frame with a partly valid carry."""
    got, ref = head_frames[kind]
    g, r = tp.to_np(getattr(got, name)), np.asarray(getattr(ref, name))
    assert g.shape == r.shape and g.shape[2] == A + K
    np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["empty", "partial"])
def test_dead_rows_bit_equal(setup, head_frames, kind):
    """Every empty slot gives the dead row (cls [20, -20], zero geometry
    and length, xs -2) in both branches at every stage, bit-equal in both
    packages; a valid slot does not."""
    got, ref = head_frames[kind]
    valid = carry(kind)[2]
    dead = tp.to_np(setup[3].head.dead_row)
    np.testing.assert_array_equal(dead, np.concatenate(
        [[20.0, -20.0], np.zeros(4), np.full(12, -2.0)]).astype(np.float32))
    for name in ("pred_fir", "pred_sec"):
        g = tp.to_np(getattr(got, name))[:, :, A:]
        r = np.asarray(getattr(ref, name))[:, :, A:]
        np.testing.assert_array_equal(g[:, ~valid], r[:, ~valid])
        assert (g[:, ~valid] == dead).all()
        assert not (g[:, valid] == dead).all(axis=-1).any()


def test_tgt_mask_blocks_dead_rows():
    """The decoder's ``tgt_mask`` (``test_head_v3.py``'s check): garbage
    in the masked target rows does not reach the valid rows; without the
    mask it does. (The head tests above hold the masked decoder to JAX's.)
    """
    d, k, a = 16, 4, 6
    rng = np.random.default_rng(0)
    tgt = torch.from_numpy(rng.normal(size=(1, k, d)).astype(np.float32))
    mem = torch.from_numpy(rng.normal(size=(1, a, d)).astype(np.float32))
    mem_mask = torch.ones((1, a), dtype=torch.bool)
    tgt_mask = torch.tensor([[True, True, False, False]])
    dec = TemporalDecoder(d, 1, 4, 32, 0.0).eval()
    dec.reset_parameters(torch.Generator().manual_seed(0))
    garbage = tgt.clone()
    garbage[:, 2:] = 1e3
    with torch.no_grad():
        masked = [dec(x, mem, mem_mask, tgt_mask=tgt_mask)[:, :2]
                  for x in (tgt, garbage)]
        unmasked = [dec(x, mem, mem_mask)[:, :2] for x in (tgt, garbage)]
    torch.testing.assert_close(masked[0], masked[1], rtol=0, atol=1e-5)
    assert (unmasked[0] - unmasked[1]).abs().max() > 1e-3


@pytest.fixture(scope="module")
def pipelines(setup):
    jc, tc, variables, _ = setup
    return tp.pipelines(jc, tc, variables, CHUNK)


@pytest.fixture(scope="module")
def clip(pipelines):
    """A 3-frame clip through both pipelines' chunk functions (``detect``
    from an empty carry): kept rows, valid flags, keep counts, the carry
    after each frame's prefix being the last frame's."""
    jpipe, tpipe = pipelines("none")
    frames = tp.seeded_frames(1, (1, CHUNK) + FRAME)
    jk, jv, jmem = jpipe._run_chunk(
        jpipe.variables, jnp.asarray(frames),
        jax_init_memory(jpipe.mcfg, 1, jpipe.memory_window))
    with torch.no_grad():
        out, mem = tpipe.model(torch.from_numpy(frames),
                               dyn_combined=tpipe._dyn,
                               initial_memory=torch_init_memory(
                                   tpipe.mcfg, 1, tpipe.memory_window))
    return out, mem, (jk, jv, jmem)


def test_clip_through_detect(clip):
    """Kept rows within 1e-4, valid flags and keep counts equal; the
    propagated rows were kept at least once (the carry reached NMS)."""
    out, _, (jk, jv, _) = clip
    np.testing.assert_array_equal(tp.to_np(out.kept_valid), np.asarray(jv))
    np.testing.assert_array_equal(tp.to_np(out.num_kept),
                                  np.asarray(jv).sum(-1))
    np.testing.assert_allclose(tp.to_np(out.kept), np.asarray(jk), rtol=0,
                               atol=1e-4)
    assert int(tp.to_np(out.num_kept).sum()) > 0
    assert (tp.to_np(out.keep_idx) >= A).any()


@pytest.mark.parametrize("name", CARRY)
def test_clip_carry_matches_jax(clip, name):
    """The carry after the clip: features and priors within 1e-4, the
    mask equal, and the frame count."""
    _, mem, (_, _, jmem) = clip
    g, r = tp.to_np(getattr(mem, name)), np.asarray(getattr(jmem, name))
    assert g.shape == r.shape
    if name == "mask":
        np.testing.assert_array_equal(g, r)
        assert g.any()
    else:
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
    assert mem.t == int(jmem.t) == CHUNK


def test_server_matches_jax(setup):
    """Two streams through both servers: a skipped tick (the skipping
    stream keeps its whole carry), detach and attach (its slots cleared),
    a weight swap; the carry's mask equal every tick."""
    jc, tc, variables, _ = setup
    js = JaxServer(jcfg.Config(model=jc), tp.jax_tree(variables),
                   max_streams=2)
    ts = TorchServer(tcfg.Config(model=tc), convert(variables),
                     max_streams=2, device="cpu")
    assert ts.window == js.window == 1
    swap = tp.init_variables(jc, seed=SEED + 2)
    assert tp.drive_servers(js, ts, swap, FRAME) > 0
    for name in ("feat", "priors"):
        np.testing.assert_allclose(tp.to_np(getattr(ts.memory, name)),
                                   np.asarray(getattr(js.memory, name)),
                                   rtol=0, atol=1e-4)


def test_server_keeps_a_skipping_streams_carry(setup):
    """A stream without a frame this tick keeps its pre-tick carry whole
    (features, priors, mask), bit for bit."""
    _, tc, variables, _ = setup
    ts = TorchServer(tcfg.Config(model=tc), convert(variables),
                     max_streams=2, device="cpu")
    for _ in range(2):
        ts.attach()
    ts.step_async({s: tp.seeded_frames(s, FRAME) for s in (0, 1)})
    before = ts.memory
    assert before.mask[1].any()
    ts.step_async({0: tp.seeded_frames(7, FRAME)})
    for name in CARRY:
        assert torch.equal(getattr(ts.memory, name)[1],
                           getattr(before, name)[1]), name
    assert ts.memory.t == 2
    ts.detach(1)
    assert not ts.memory.mask[1].any() and ts.memory.mask[0].any()


def test_pipeline_matches_jax(pipelines, tmp_path):
    """Clips of 5 and 4 frames in chunks of 3 (the carry crosses the
    chunks; the last chunk is padded), emitted in the OL format."""
    jpipe, tpipe = pipelines("none")
    assert tpipe.memory_window == jpipe.memory_window == 1
    assert tp.compare_pipelines(jpipe, tpipe, tp.ol_clips(FRAME),
                                tmp_path) > 0


def test_w8_head_matches_jax(setup):
    """The head on the partly valid carry with w8 DynamicConv chains:
    every output within 1e-1 and 90% of them within 1e-4 (see the module
    docstring)."""
    got, ref = run_head(setup, "partial", "w8")
    for name in HEAD_OUTPUTS:
        g, r = tp.to_np(getattr(got, name)), np.asarray(getattr(ref, name))
        np.testing.assert_allclose(g, r, rtol=0, atol=QUANT_ATOL,
                                   err_msg=name)
        assert np.percentile(np.abs(g - r), 90) <= QUANT_P90, name


def test_bf16_clip_matches_jax(setup):
    """``PHNet.forward`` in bf16 over a 3-frame clip of 4 streams against
    the ``exact_jit`` JAX clip, by the one-ulp method: keep counts and
    kept rows on the robust slots, the carry's features on the robust
    streams; the outputs and the carry float32."""
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
                         np.asarray(mem.feat)))
        with torch.no_grad():
            out, mem = tm(torch.from_numpy(copy))
        assert out.kept.dtype == mem.feat.dtype == torch.float32
        port_runs.append((tp.to_np(out.num_kept),
                          tb.masked_rows(out.kept, out.kept_valid),
                          tp.to_np(mem.feat)))
    ref = {"num_kept": jax_runs[0][0], "kept": jax_runs[0][1],
           "memory": jax_runs[0][2], "robust": tb.robust_slots(jax_runs)}
    tb.check_against(ref, port_runs)
