"""bfloat16 inference of the port (``compute_dtype="bfloat16"``, the JAX
package's headline configuration) against the JAX package on the small
configurations of ``torch_parity``; and the router chain's bf16 mode,
which the JAX server turns on above 8 streams in float32 as in bfloat16.

The oracle. XLA on the CPU keeps excess precision by default: it runs a
bf16 convolution or dot in float32 and hands its float32 output on, so
that only the program's own casts round (its FPN levels are not even bf16
values). The port rounds every bf16 product, as the card does and as the
JAX program states. Against that default the two differ in nearly every
element by up to a few bf16 ulps, and a lane whose score lies within that
noise of the confidence threshold keeps or drops in one and not the
other. So the JAX side is compiled with ``xla_allow_excess_precision``
off (:func:`exact_jit`): XLA then rounds wherever the program computes in
bf16, and the two implementations differ only in summation order inside
a product, that is in rare elements by one ulp.

Tolerances, each from the port against that oracle and from the port's
own spread when its input moves by one bf16 ulp (each element times ``1 +
k * 2**-8``, k drawn from -1, 0, 1), measured on the same data (numbers
beside each constant).

Keep decisions. Even so a rare one-ulp difference can decide a lane whose
score lies that close to the confidence threshold, or which of two lanes
NMS keeps: the port's own clip and server, whose encoders sum in other
orders (one batch of all frames, or one of a tick's), disagree on such a
lane in the w8 clip here, and so does the port against its own one-ulp
runs. So the clip, server and pipeline tests run both packages on three
one-ulp copies of the frames besides the frames (:data:`ULP_SEEDS`), and
call a (frame, stream) slot *robust* where, in each package, all four
runs keep the same number of lanes with kept rows within ``KEPT_ATOL``
(in the OL clip a slot that the port's copies leave alone is one where
the JAX package's copies trade two lanes of near-equal score). On every
robust slot the port's keep count equals the JAX package's and its kept
rows are within ``KEPT_ATOL`` of them; at least ``ROBUST_MIN`` of the
slots are robust and they keep lanes; memory values are held on the
streams whose slots are all robust.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phnet_torch.config as tcfg
import phnet_tpu.config as jcfg
from phnet_torch.convert import convert
from phnet_torch.models.dynamic_conv import DynamicConv as TorchDynamicConv
from phnet_torch.models.phnet import init_memory as torch_init_memory
from phnet_torch.models.router import AdaptiveRouter as TorchRouter
from phnet_torch.ops import router_chain as trc
from phnet_torch.pipeline import InferencePipeline as TorchPipeline
from phnet_torch.serving import StreamingServer as TorchServer
from phnet_torch.serving import resolve_chain_bf16
from phnet_tpu.models import PHNet as JaxPHNet
from phnet_tpu.models.dynamic_conv import DynamicConv as JaxDynamicConv
from phnet_tpu.models.dynamic_conv import combine_dynamic_params
from phnet_tpu.models.head import LaneHead as JaxLaneHead
from phnet_tpu.models.phnet import init_memory as jax_init_memory
from phnet_tpu.models.router import AdaptiveRouter as JaxRouter
from phnet_tpu.ops.router_pallas import _conv3x3, _ln
from phnet_tpu.serving import StreamingServer as JaxServer

import torch_parity as tp

BF16 = {"compute_dtype": "bfloat16"}
T, WINDOW = 3, 128  # clip frames; the ring (the VIL pipeline's window)
# tolerances (measured: the port vs the oracle; the port's own one-ulp
# spread, each element moved by -1, 0 or +1 ulp)
ENCODER_REL = 2.5e-2   # of max |level|: 0 (bit-equal); 1.2e-2
HEAD_ATOL = 0.5        # a head output: 0.125; 0.28
HEAD_P99 = 0.125       # its 99th percentile: 0.0625; 0.0625
DYN_ATOL = 0.1         # DynamicConv: 0 (bit-equal in all modes); 0.053
KEPT_ATOL = 0.5        # kept rows, robust slots: 0.094; 0.30
MEM_ATOL = 0.25        # memory, robust streams: 0.047; 0.16
CHAIN_ATOL = 0.5       # bf16 chain, plain vs JAX's (max 12.2): 0.225; 0.25
SCORE_ATOL = 1.5e-2    # router scores, bf16 chain: 0.0095; 0.0068
MODES = ["none", "w8", "int8"]
ULP_SEEDS = (5, 6, 7)  # the one-ulp copies of a clip's frames
ROBUST_MIN = 1 / 3    # slots robust in both packages: measured 5-6 of 12


def exact_jit(fn):
    """``jax.jit`` with XLA's excess precision off: bf16 rounding wherever
    the program computes in bf16 (see the module docstring)."""
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision":
                                         False})


def cfgs(ol=False, **kw):
    """(JAX, port) small ModelConfigs in bf16 with ``kw``."""
    if ol:
        pair = tp.small_ol_cfg(jcfg), tp.small_ol_cfg(tcfg)
    else:
        pair = tp.jax_cfg(), tp.torch_cfg()
    return tuple(dataclasses.replace(c, **BF16, **kw) for c in pair)


@pytest.fixture(scope="module")
def weights():
    return tp.init_variables(tp.jax_cfg(), seed=0)


@pytest.fixture(scope="module")
def ol_weights():
    return tp.init_variables(tp.small_ol_cfg(jcfg), seed=3)


def one_ulp(x, seed=5):
    """x with each element moved by -1, 0 or +1 bf16 ulp (relative)."""
    k = np.random.default_rng(seed).integers(-1, 2, x.shape)
    return (x * (1.0 + k * 2.0 ** -8)).astype(np.float32)


def spread(got, ref):
    """(max, 99th percentile) of |got - ref|."""
    d = np.abs(tp.to_np(got).astype(np.float32)
               - np.asarray(ref, np.float32))
    return float(d.max()), float(np.percentile(d, 99))


# -- configuration --------------------------------------------------------

def test_compute_dtype_is_checked():
    """An unknown compute dtype fails; every preset builds in bf16 (the
    multi-scale one too, whose head reads no compute dtype), its fields
    those of the float32 preset and of the JAX preset but for the dtype;
    the router chain's bf16 flag stays None (the server decides)."""
    with pytest.raises(ValueError, match="compute_dtype"):
        dataclasses.replace(tp.torch_cfg(), compute_dtype="float16")
    ms = tcfg.openlane_multiscale_config(compute_dtype="bfloat16").model
    ref = jcfg.openlane_multiscale_config().model
    assert ms.compute_dtype == "bfloat16"
    tp.check_fields(ms, dataclasses.replace(ref, compute_dtype="bfloat16"),
                    differ={"model.head.dyn_param_reduction": 4})
    for preset in ("vil100_config", "openlane_config",
                   "openlane_multiscale_config",
                   "openlane_propagate_config"):
        got = getattr(tcfg, preset)(compute_dtype="bfloat16")
        ref = getattr(jcfg, preset)()
        assert got.model.compute_dtype == "bfloat16"
        assert dataclasses.replace(got.model, compute_dtype="float32") == (
            getattr(tcfg, preset)().model)
        assert ref.model.head.router_chain_bf16 is None
        assert got.model.head.router_chain_bf16 is None


def test_bridge_needs_no_change(weights):
    """The parameters stay float32 (flax's param_dtype; the casts happen at
    use): the same state dict loads strictly into the f32 and the bf16
    model, and nothing of the bf16 model is stored in bf16."""
    _, tc = cfgs()
    sd = convert(weights)
    tm = tp.torch_model(tc, weights)
    assert all(v.dtype in (torch.float32, torch.int64, torch.bool)
               for v in tm.state_dict().values())
    for name, value in tm.state_dict().items():
        assert torch.equal(value, sd[name]), name


# -- modules on equal inputs ----------------------------------------------

def test_encoder_matches_jax(weights):
    """The FPN levels (float32 out, bf16 values): within ``ENCODER_REL``
    of max |level|."""
    jc, tc = cfgs()
    frames = tp.seeded_frames(1, (2, 2, 64, 128, 3))
    jm = JaxPHNet(jc)
    ref = exact_jit(lambda v, f: jm.apply(v, f, method=jm.encode))(
        tp.jax_tree(weights), jnp.asarray(frames))
    tm = tp.torch_model(tc, weights)
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(frames))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        scale = float(np.abs(np.asarray(r)).max())
        assert spread(g, r)[0] <= ENCODER_REL * scale


def jax_combines(jc, variables):
    """The JAX server's pre-permuted combines, in its compute dtype."""
    h = jc.head
    hp = tp.jax_tree(variables)["params"]["frame"]["head"]
    return tuple(combine_dynamic_params(
        hp[f"dyn_head_{s}"], h.fc_hidden_dim, h.dyn_dim_factor,
        quantize=jc.quantize, c_major=True, dtype=jnp.bfloat16)
        for s in range(h.refine_layers))


def head_frame(jc, tc, variables):
    """One head frame of both packages on injected bf16-valued features
    and a memory bank with some valid slots."""
    rng = np.random.default_rng(12)
    b, c = 2, tc.neck.out_channels
    hw = [(tc.img_h // s, tc.img_w // s) for s in (8, 16, 32)]
    feats = [tp.to_np(torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(
        np.float32)).bfloat16().float()) for h, w in hw]
    s, m, d = jc.head.refine_layers, 12, jc.head.attn_dim
    mem_vals = rng.normal(size=(b, s, m, d)).astype(np.float32)
    mem_mask = rng.uniform(size=(b, m)) < 0.5
    head = JaxLaneHead(jc)
    ref = exact_jit(lambda p, f, v, mk, dyn: head.apply(
        {"params": p}, f, v, mk, train=False, dyn_combined=dyn,
        dyn_pre_permuted=True))(
        tp.jax_tree(variables["params"]["frame"]["head"]),
        tuple(map(jnp.asarray, feats)), jnp.asarray(mem_vals),
        jnp.asarray(mem_mask), jax_combines(jc, variables))
    tm = tp.torch_model(tc, variables)
    with torch.no_grad():
        got = tm.head(tuple(map(torch.from_numpy, feats)),
                      torch.from_numpy(mem_vals), torch.from_numpy(mem_mask))
    return got, ref


@pytest.mark.parametrize("preset", ["vil", "ol"])
def test_head_frame_matches_jax(preset, weights, ol_weights):
    """Every per-stage output of one head frame (VIL and the small OL
    single head): within ``HEAD_ATOL``, the 99th percentile within
    ``HEAD_P99``."""
    jc, tc = cfgs(ol=preset == "ol")
    got, ref = head_frame(jc, tc, ol_weights if preset == "ol" else weights)
    for name in ("pred_fir", "pred_sec", "diff", "attn_feat"):
        g, r = getattr(got, name), getattr(ref, name)
        assert g.dtype == torch.float32 and g.shape == r.shape, name
        top, p99 = spread(g, r)
        assert top <= HEAD_ATOL and p99 <= HEAD_P99, (name, top, p99)


@pytest.mark.parametrize("mode", MODES)
def test_dynamic_conv_matches_jax(mode, weights):
    """DynamicConv in bf16 on equal inputs, with the combines each package
    serves (JAX's pre-permuted, in bf16 where unquantized): within
    ``DYN_ATOL``; float32 out."""
    jc, _ = cfgs(quantize=mode)
    c, feat, a = jc.head.fc_hidden_dim, jc.head.sample_points, 32
    p = weights["params"]["frame"]["head"]["dyn_head_1"]
    rng = np.random.default_rng(10)
    pro = rng.normal(size=(2, a, c)).astype(np.float32)
    roi = rng.normal(size=(2, a, feat, c)).astype(np.float32)
    comb = combine_dynamic_params(tp.jax_tree(p), c, 2, quantize=mode,
                                  c_major=True, dtype=jnp.bfloat16)
    jm = JaxDynamicConv(feat_size=feat, hidden_dim=c, pro_dim=c,
                        quantize=mode, dtype=jnp.bfloat16)
    ref = exact_jit(lambda pp, a_, b_, cb: jm.apply(
        {"params": pp}, a_, b_, combined=cb, pre_permuted=True))(
        tp.jax_tree(p), jnp.asarray(pro), jnp.asarray(roi), comb)
    tm = TorchDynamicConv(feat_size=feat, hidden_dim=c, pro_dim=c,
                          quantize=mode, dtype=torch.bfloat16)
    sd = {f"{n}.weight": torch.from_numpy(p[n]["kernel"].T.copy())
          for n in ("gen1_a", "gen1_b", "gen2_a", "gen2_b", "out_a",
                    "out_b")}
    sd.update({f"{n}.bias": torch.from_numpy(p[n]["bias"])
               for n in ("gen1_a", "gen1_b", "gen2_a", "gen2_b", "out_a",
                         "out_b")})
    for i in (1, 2, 3):
        sd[f"norm{i}.weight"] = torch.from_numpy(p[f"norm{i}"]["scale"])
        sd[f"norm{i}.bias"] = torch.from_numpy(p[f"norm{i}"]["bias"])
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(pro), torch.from_numpy(roi))
    assert got.dtype == torch.float32
    assert spread(got, ref)[0] <= DYN_ATOL


@pytest.mark.parametrize("mode", ["w8", "int8"])
def test_quantized_products_take_bf16_x(mode):
    """A bf16 activation goes into the w8 product as it is and into the
    int8 one upcast: each gives the bits of its float32 call on the same
    values (the w8 wrapper's plain version here, the kernel on the card:
    ``chip_smoke.py::phase_w8_bf16x``)."""
    from phnet_torch.ops import quant as tq
    from phnet_torch.ops.w8_matmul import w8_matmul

    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.normal(size=(70, 96)).astype(
        np.float32)).bfloat16()
    wq, sw = tq.quantize_colwise(torch.from_numpy(rng.normal(
        size=(96, 40)).astype(np.float32)))
    mm = w8_matmul if mode == "w8" else tq.int8_matmul_prequant
    got = mm(x, wq, sw)
    assert got.dtype == torch.float32
    assert torch.equal(got, mm(x.float(), wq, sw))


# -- the router and its chain ---------------------------------------------

def router_inputs(seed=7, a=32, c=16, p=12, blocks=4):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(2, a, c, p)).astype(np.float32)
    taps = rng.uniform(-1 / 3, 1 / 3, (a, blocks * 18)).astype(np.float32)
    bias = rng.normal(0, 0.05, (a, blocks * 2)).astype(np.float32)
    lnp = rng.normal(0, 0.05, (2 + 4 * blocks, c, p)).astype(np.float32)
    lnp[[0] + [2 + 4 * b + o for b in range(blocks) for o in (0, 2)]] += 1.0
    dense = {"Dense_0": {"kernel": rng.normal(size=(c * p, c * p // 4)) / 14,
                         "bias": rng.normal(0, 0.05, c * p // 4)},
             "Dense_1": {"kernel": rng.normal(size=(c * p // 4, 1)) / 7,
                         "bias": np.full(1, 0.3)}}
    dense = {k: {n: v.astype(np.float32) for n, v in d.items()}
             for k, d in dense.items()}
    params = {"taps": taps, "conv_bias": bias, "ln_params": lnp, **dense}
    return feats, params


def torch_router(params, **kw):
    a, n = params["taps"].shape
    _, c, p = params["ln_params"].shape
    r = TorchRouter(a, c, p, 4, n // 18, **kw)
    sd = {"taps": params["taps"], "conv_bias": params["conv_bias"],
          "ln_params": params["ln_params"]}
    for i in (0, 1):
        sd[f"dense{i}.weight"] = params[f"Dense_{i}"]["kernel"].T.copy()
        sd[f"dense{i}.bias"] = params[f"Dense_{i}"]["bias"]
    r.load_state_dict({k: torch.from_numpy(np.asarray(v))
                       for k, v in sd.items()}, strict=True)
    return r.eval()


def jax_chain_bf16(feats, params):
    """The chain of ``phnet_tpu/models/router.py`` with ``cdtype =
    bfloat16``, by the JAX package's own helpers (the oracle's
    compilation)."""
    @exact_jit
    def chain(x, taps, bias, lnp):
        bf = jnp.bfloat16
        b, a, c, p = x.shape
        taps_b = jnp.tile(taps, (b, 1)).astype(bf)
        bias_b = jnp.tile(bias, (b, 1)).astype(bf)
        x = _ln(x.reshape(b * a, c, p), lnp[0], lnp[1]).astype(bf)
        for blk in range(taps.shape[1] // 18):
            o = 2 + 4 * blk
            y = _conv3x3(x, taps_b[:, 18 * blk:18 * blk + 9],
                         bias_b[:, 2 * blk]).astype(bf)
            y = jnp.maximum(_ln(y, lnp[o], lnp[o + 1]).astype(bf), 0.0)
            y = _conv3x3(y, taps_b[:, 18 * blk + 9:18 * blk + 18],
                         bias_b[:, 2 * blk + 1]).astype(bf)
            y = _ln(y, lnp[o + 2], lnp[o + 3]).astype(bf)
            x = jnp.maximum(y + x, 0.0).astype(bf)
        return x
    return chain(*map(jnp.asarray, (feats, params["taps"],
                                    params["conv_bias"],
                                    params["ln_params"])))


def test_router_chain_bf16_plain_matches_jax():
    """``router_chain_plain(bf16=True)`` against the JAX chain with bf16
    intermediates: bf16 out; within ``CHAIN_ATOL``. The JAX chain rounds
    each of a 3x3's nine products and sums to bf16, the plain version the
    whole 3x3 once: 60% of the elements differ, by 0.225 at most where the
    output reaches 12.2 (a bf16 ulp is 0.0625 there), as far as the plain
    version moves under a one-ulp change of its input (0.25)."""
    feats, params = router_inputs()
    ref = np.asarray(jax_chain_bf16(feats, params).astype(jnp.float32))
    args = (params["taps"], params["conv_bias"], params["ln_params"])
    x = torch.from_numpy(feats.reshape(-1, *feats.shape[2:]))
    got = trc.router_chain_plain(x, *map(torch.from_numpy, args), 4,
                                 bf16=True)
    assert got.dtype == torch.bfloat16
    assert spread(got.float(), ref.reshape(got.shape))[0] <= CHAIN_ATOL


def test_router_chain_bf16_rounds_where_documented():
    """The plain bf16 chain is the float32 chain with bf16 rounding at the
    documented points: every intermediate it returns is a bf16 value, and
    without rounding (a float32 copy of the same steps) it is the float32
    chain bit for bit; the wrapper on CPU tensors runs it and counts no
    kernel launch."""
    feats, params = router_inputs(seed=3)
    x = torch.from_numpy(feats.reshape(-1, *feats.shape[2:]))
    args = tuple(torch.from_numpy(params[k])
                 for k in ("taps", "conv_bias", "ln_params"))
    before = (trc.router_chain.launches, trc.router_chain.launches_bf16)
    got = trc.router_chain(x, *args, 4, bf16=True)
    assert (trc.router_chain.launches,
            trc.router_chain.launches_bf16) == before
    assert torch.equal(got, trc.router_chain_plain(x, *args, 4, bf16=True))
    assert torch.equal(trc.router_chain(x, *args, 4),
                       trc.router_chain_plain(x, *args, 4))
    f32 = trc.router_chain_plain(x, *args, 4).float()
    assert (got.float() - f32).abs().max() > 0  # it does round
    # one block by hand: LN0, 3x3, LN, ReLU, 3x3, LN, residual, rounded
    r = trc._round_bf16
    taps, bias, lnp = r(args[0].repeat(2, 1)), r(args[1].repeat(2, 1)), \
        args[2]
    y0 = r(trc.layer_norm_cp(x, lnp[0], lnp[1]))
    y = r(trc.conv3x3_depthwise(y0, taps[:, :9], bias[:, 0]))
    y = torch.relu(r(trc.layer_norm_cp(y, lnp[2], lnp[3])))
    y = r(trc.conv3x3_depthwise(y, taps[:, 9:18], bias[:, 1]))
    y = r(trc.layer_norm_cp(y, lnp[4], lnp[5]))
    one = torch.relu(r(y + y0))
    assert torch.equal(trc.router_chain_plain(x, *args, 1, bf16=True),
                       one.bfloat16())


@pytest.mark.parametrize("chain_bf16", [False, True])
def test_router_bf16_compute_matches_jax(chain_bf16):
    """``AdaptiveRouter`` with a bf16 MLP: with the f32 chain, bit-equal to
    the port's f32 chain fed to the same bf16 MLP by hand; with the bf16
    chain, the chain's bf16 output straight into the MLP. Scores within
    ``SCORE_ATOL`` of JAX's ``AdaptiveRouter(dtype=bf16, chain_bf16)``."""
    feats, params = router_inputs(seed=11)
    tr = torch_router(params, dtype=torch.bfloat16, chain_bf16=chain_bf16)
    with torch.no_grad():
        got = tr(torch.from_numpy(feats))
        b, a, c, p = feats.shape
        x = trc.router_chain_plain(
            torch.from_numpy(feats.reshape(b * a, c, p)), tr.taps,
            tr.conv_bias, tr.ln_params, 4, bf16=chain_bf16)
        x = x.reshape(b, a, c * p).bfloat16()
        w0, b0 = tr.dense0.weight.bfloat16(), tr.dense0.bias.bfloat16()
        w1, b1 = tr.dense1.weight.bfloat16(), tr.dense1.bias.bfloat16()
        h = torch.relu(x @ w0.t() + b0)
        by_hand = torch.sigmoid(torch.relu(h @ w1.t() + b1).float())
    assert got.dtype == torch.float32
    assert torch.equal(got, by_hand)
    jr = JaxRouter(num_anchors=a, channels=c, points=p, dtype=jnp.bfloat16,
                   chain_bf16=chain_bf16)
    ref = exact_jit(lambda pp, x: jr.apply({"params": pp}, x))(
        tp.jax_tree(params), jnp.asarray(feats))
    assert spread(got, ref)[0] <= SCORE_ATOL


# -- clips, servers and pipelines -----------------------------------------

@pytest.fixture(scope="module")
def clip_refs(weights, ol_weights):
    """The JAX clip of each (preset, mode), compiled once: 4 streams of
    ``T`` frames from an empty ring of ``WINDOW`` frames (the pipeline's
    VIL window, so that the server and the pipeline read the same
    reference), and its robust slots over the frames' one-ulp copies."""
    made = {}

    def get(preset, mode):
        if (preset, mode) not in made:
            ol = preset == "ol"
            jc, _ = cfgs(ol=ol, quantize=mode)
            variables = ol_weights if ol else weights
            frames = tp.seeded_frames(1, (4, T, jc.img_h, jc.img_w, 3))
            jm = JaxPHNet(jc)
            clip = exact_jit(lambda v, f, m, dyn: jm.apply(
                v, f, None, train=False, initial_memory=m,
                dyn_combined=dyn))
            runs = []
            for copy in ulp_copies(frames):
                out, mem = clip(tp.jax_tree(variables), jnp.asarray(copy),
                                jax_init_memory(jc, 4, WINDOW),
                                jax_combines(jc, variables))
                runs.append((np.asarray(out.num_kept),
                             masked_rows(out.kept, out.kept_valid),
                             np.asarray(mem.values)))
            made[(preset, mode)] = (frames, {
                "num_kept": runs[0][0], "kept": runs[0][1],
                "memory": runs[0][2], "robust": robust_slots(runs)})
        return made[(preset, mode)]

    return get


def masked_rows(kept, valid):
    kept, valid = tp.to_np(kept), tp.to_np(valid)
    return np.where(valid[..., None], kept, 0.0).astype(np.float32)


def ulp_copies(frames):
    return [frames] + [one_ulp(frames, seed) for seed in ULP_SEEDS]


def robust_slots(runs):
    """runs: (num_kept [T, B], kept rows [T, B, K, dim], ...) for
    :func:`ulp_copies` of the frames; True where every copy keeps the
    first run's count with kept rows within ``KEPT_ATOL``."""
    counts, rows = runs[0][:2]
    robust = np.ones(counts.shape, bool)
    for c2, r2 in (r[:2] for r in runs[1:]):
        robust &= (c2 == counts) & (np.abs(r2 - rows).max(axis=(-2, -1))
                                    <= KEPT_ATOL)
    return robust


def check_against(ref, runs, robust_min=ROBUST_MIN):
    """runs: the port's (num_kept [T, B], kept rows [T, B, K, dim], memory
    or None) for :func:`ulp_copies` of the frames. Holds the first to
    ``ref`` on the slots robust in both packages (see the module
    docstring), at least ``robust_min`` of them."""
    counts, rows, memory = runs[0]
    robust = robust_slots(runs) & ref["robust"]
    assert robust.mean() >= robust_min, robust
    np.testing.assert_array_equal(counts[robust], ref["num_kept"][robust])
    assert int(counts[robust].sum()) > 0
    assert np.abs(rows - ref["kept"])[robust].max() <= KEPT_ATOL
    streams = robust.all(axis=0)
    if memory is not None and streams.any():
        assert np.abs(memory - ref["memory"])[streams].max() <= MEM_ATOL


@pytest.mark.parametrize("preset,mode", [("vil", m) for m in MODES]
                         + [("ol", "none")])
def test_clip_matches_jax(preset, mode, weights, ol_weights, clip_refs):
    """``PHNet.forward`` over the clip (VIL in every mode, the small OL
    single head unquantized)."""
    frames, ref = clip_refs(preset, mode)
    _, tc = cfgs(ol=preset == "ol", quantize=mode)
    tm = tp.torch_model(tc, ol_weights if preset == "ol" else weights)
    runs = []
    for clip in ulp_copies(frames):
        with torch.no_grad():
            out, mem = tm(torch.from_numpy(clip),
                          initial_memory=torch_init_memory(tc, 4, WINDOW))
        assert out.kept.dtype == mem.values.dtype == torch.float32
        runs.append((tp.to_np(out.num_kept),
                     masked_rows(out.kept, out.kept_valid),
                     tp.to_np(mem.values)))
    check_against(ref, runs)


@pytest.mark.parametrize("mode", ["none", "w8"])
def test_server_matches_jax(mode, weights, clip_refs):
    """The bf16 server at 4 streams (its chain stays float32 at 4), every
    stream sending a frame a tick: tick t is frame t of the clip."""
    frames, ref = clip_refs("vil", mode)
    _, tc = cfgs(quantize=mode)
    runs = []
    for clip in ulp_copies(frames):
        ts = TorchServer(tcfg.Config(model=tc), convert(weights),
                         max_streams=4, memory_window=WINDOW, device="cpu")
        assert ts.mcfg.head.router_chain_bf16 is False
        for _ in range(4):
            ts.attach()
        counts, rows = [], []
        for t in range(T):
            kept, valid, _ = ts.step_async({s: clip[s, t] for s in range(4)})
            counts.append(tp.to_np(valid).sum(-1))
            rows.append(masked_rows(kept, valid))
        runs.append((np.stack(counts), np.stack(rows),
                     tp.to_np(ts.memory.values)))
    check_against(ref, runs)


def test_pipeline_matches_jax(weights, clip_refs):
    """The bf16 clip pipeline over each stream's frames in chunks of 2 (the
    memory carried across chunks, the last chunk padded): per frame robust
    in both packages (the pipeline's own one-ulp runs; the JAX clip's) the
    lanes decoded from the JAX clip's kept rows, in count and within 1 px
    (the VIL format's integer pixels)."""
    from phnet_torch.geometry import decode_kept_rows

    frames, ref = clip_refs("vil", "none")
    _, tc = cfgs()
    pipe = TorchPipeline(tcfg.Config(model=tc), convert(weights), chunk=2,
                         device="cpu")
    assert pipe.memory_window == WINDOW
    assert pipe.mcfg.head.router_chain_bf16 is None  # off: never auto
    n_robust = n_lanes = 0
    for b in range(4):
        lanes, *others = [pipe.run_video(clip)[0]
                          for clip in ulp_copies(frames[b])]
        for t in range(T):
            if not ref["robust"][t, b] or any(len(lanes[t]) != len(
                    again[t]) or any(
                    a.points.shape != c.points.shape
                    or np.abs(a.points - c.points).max() > 1.0
                    for a, c in zip(lanes[t], again[t]))
                   for again in others):
                continue
            n_robust += 1
            want = decode_kept_rows(
                ref["kept"][t, b][:ref["num_kept"][t, b]], tc.lane)
            assert len(lanes[t]) == len(want), (b, t)
            for a, c in zip(want, lanes[t]):
                assert a.points.shape == c.points.shape
                assert np.abs(a.points - c.points).max() <= 1.0
                n_lanes += 1
    assert n_robust >= ROBUST_MIN * 4 * T and n_lanes > 0


# -- the server's chain mode (the JAX server's rule) ----------------------

def test_chain_mode_resolves_as_jax_server():
    """``router_chain_bf16=None`` resolves to ``max_streams > 8``; a pinned
    value stays (``phnet_tpu/serving.py:255-263``)."""
    cfg = tcfg.Config(model=tp.torch_cfg())
    for streams, want in ((8, False), (9, True), (16, True)):
        got = resolve_chain_bf16(cfg, streams).model.head.router_chain_bf16
        assert got is want
    for pin in (False, True):
        head = dataclasses.replace(cfg.model.head, router_chain_bf16=pin)
        pinned = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, head=head))
        assert resolve_chain_bf16(pinned, 16).model.head.router_chain_bf16 \
            is pin


def test_f32_server_above_8_streams_matches_jax(weights):
    """The float32 server at 9 streams runs the router chain in its bf16
    mode, as the JAX server does there (until this mode the port served
    the float32 chain at every width): the resolved flag, on every router;
    keep masks equal in every slot and kept rows within 2e-2 of the JAX
    server (measured 6.0e-3; the port's own one-ulp spread 4.1e-2). The
    kept rows alone cannot tell the chain's modes apart here: the chain
    only moves the blend of the stages' priors, and the JAX chain (XLA's
    default compile) rounds at points of its own, 0.19 from the plain bf16
    chain and 0.23 from the float32 one, so the float32 chain's kept rows
    were 1.7e-3 from the JAX server's. What fails on the float32-only port
    is the mode itself."""
    js = JaxServer(jcfg.Config(model=tp.jax_cfg()), tp.jax_tree(weights),
                   max_streams=9, memory_window=4)
    ts = TorchServer(tcfg.Config(model=tp.torch_cfg()), convert(weights),
                     max_streams=9, memory_window=4, device="cpu")
    assert js.mcfg.head.router_chain_bf16 is True
    assert ts.mcfg.head.router_chain_bf16 is True
    assert all(r.chain_bf16 for r in ts.model.head.routers)
    for server in (js, ts):
        for _ in range(9):
            server.attach()
    n_kept = 0
    for t in range(3):
        frames = {s: tp.seeded_frames(100 * t + s, (64, 128, 3))
                  for s in range(9)}
        jk, jv, _ = js.step_async(frames)
        tk, tv, _ = ts.step_async(frames)
        np.testing.assert_array_equal(tp.to_np(tv), np.asarray(jv))
        np.testing.assert_allclose(masked_rows(tk, tv),
                                   masked_rows(jk, jv), rtol=0, atol=2e-2)
        n_kept += int(tp.to_np(tv).sum())
    assert n_kept > 0
