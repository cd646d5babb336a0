"""Quantized inference of the port (``quantize="w8"`` / ``"int8"``) against
the JAX package: the quantizers, the w8 and int8 products, DynamicConv,
and the small model's head and clip.

Tolerances, and why:

- the quantizers are bit-equal to the JAX call that uses the same form
  (``quantize_colwise`` divides by 127, as the JAX server's eager weight
  quantization does; ``quantize_rowwise`` multiplies by f32(1/127), as
  XLA compiles the division inside a graph);
- the plain w8 product is within 1e-6 of max |ref| of JAX's
  ``w8_matmul_prequant`` and of ``w8_matmul_pallas(interpret=True)``: the
  same bf16 operands and f32 sums, in another order;
- the int8 product is exact on the same int8 inputs; the whole int8
  affine, whose weight scales JAX computes in-graph (reciprocal), is
  within 1e-5 of max |ref|;
- DynamicConv on identical inputs within 1e-4 (measured 5e-7): only f32
  summation order differs before each bf16 cast or int8 round;
- the model: the port's and XLA's f32 activations differ by ~1e-6 before
  each bf16 cast or int8 round, so rare elements land one bf16 ulp (2^-8)
  or one int8 step apart. Perturbing the frames by 1e-6 relative moves the
  port's own kept rows by 2e-3 (w8) and 5e-3 (int8), and the port against
  JAX measured 2.2e-3 / 4.3e-4. Kept rows and memory values are held
  within 1e-2; keep counts and slots are equal. The head's stage outputs
  on random features are more sensitive (a 1e-6 perturbation moves them
  by up to 2.8e-2 in w8 and 8.4e-2 in int8; the port against JAX measured
  2.1e-2 at most, 5.5e-6 at the 90th percentile): every element within
  1e-1, and 90% of them within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnet_torch.models.dynamic_conv import DynamicConv as TorchDynamicConv
from phnet_torch.models.phnet import init_memory as torch_init_memory
from phnet_torch.ops import quant as tq
from phnet_torch.ops.w8_matmul import w8_matmul
from phnet_tpu.models import PHNet as JaxPHNet
from phnet_tpu.models.dynamic_conv import DynamicConv as JaxDynamicConv
from phnet_tpu.models.dynamic_conv import combine_dynamic_params
from phnet_tpu.models.head import LaneHead as JaxLaneHead
from phnet_tpu.models.phnet import init_memory as jax_init_memory
from phnet_tpu.ops import quant as jq
from phnet_tpu.ops.w8_pallas import w8_matmul_pallas

import torch_parity as tp

MODES = ["w8", "int8"]
MODEL_ATOL = 1e-2
W8_SHAPES = [(240, 1024, 512), (7, 300, 60), (16, 512, 512), (100, 100, 100)]


def draw(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("k,n", [(96, 48), (300, 60), (4608, 1024)])
def test_quantize_colwise_bit_equal_to_eager_jax(k, n):
    w = draw(k + n, k, n)
    w[:, 0] = 0.0  # an all-zero column takes the 1e-8 floor
    jqw, jsw = jq.quantize_colwise(jnp.asarray(w))  # eager: true division
    tqw, tsw = tq.quantize_colwise(torch.from_numpy(w))
    assert tqw.dtype == torch.int8 and tqw.is_contiguous()
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
    np.testing.assert_array_equal(tqw.numpy(), np.asarray(jqw))


@pytest.mark.parametrize("m,k", [(32, 96), (240, 4608)])
def test_quantize_rowwise_bit_equal_to_jitted_jax(m, k):
    x = draw(m * k, m, k) * 3.0
    x[1] = 0.0
    jqx, jsx = jax.jit(jq.quantize_rowwise)(jnp.asarray(x))
    tqx, tsx = tq.quantize_rowwise(torch.from_numpy(x))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(tqx.numpy(), np.asarray(jqx))


@pytest.mark.parametrize("m,k,n", W8_SHAPES)
def test_w8_plain_matches_jax_and_pallas(m, k, n):
    """The plain version (the CPU path of the wrapper) against JAX's
    ``w8_matmul_prequant`` and the Pallas kernel in interpret mode, on the
    shapes of ``tests/test_w8_pallas.py``, within 1e-6 of max |ref|."""
    x = draw(m * 1000 + n, m, k)
    wq, sw = jq.quantize_colwise(jnp.asarray(draw(k * 7 + n, k, n)))
    ref = np.asarray(jq.w8_matmul_prequant(jnp.asarray(x), wq, sw))
    pallas = np.asarray(w8_matmul_pallas(jnp.asarray(x), wq, sw,
                                         interpret=True))
    launches = w8_matmul.launches
    got = w8_matmul(torch.from_numpy(x), torch.from_numpy(np.array(wq)),
                    torch.from_numpy(np.array(sw))).numpy()
    assert w8_matmul.launches == launches  # the CPU runs no kernel
    assert got.dtype == np.float32 and got.shape == (m, n)
    scale = np.max(np.abs(ref)) + 1e-9
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got / scale, pallas / scale, rtol=0,
                               atol=1e-6)


def test_w8_leading_dims_flatten():
    x = draw(0, 2, 3, 64)
    wq, sw = tq.quantize_colwise(torch.from_numpy(draw(1, 64, 32)))
    got = w8_matmul(torch.from_numpy(x), wq, sw)
    assert got.shape == (2, 3, 32)
    flat = w8_matmul(torch.from_numpy(x.reshape(6, 64)), wq, sw)
    assert torch.equal(got.reshape(6, 32), flat)


def test_w8_output_keeps_f32_accumulation():
    """The plain version sums in f32: a bf16 matmul would round the
    output to bf16 and lose these low bits."""
    x = torch.full((1, 3), 1.0)
    wq = torch.tensor([[127], [1], [1]], dtype=torch.int8)
    got = tq.w8_matmul_prequant(x, wq, torch.ones(1))
    assert got.item() == 129.0  # 129 is not a bf16 value


def test_int8_matmul_prequant_exact_on_same_int8_inputs():
    x = draw(3, 240, 512)
    x[5] = 0.0
    wq, sw = jq.quantize_colwise(jnp.asarray(draw(4, 512, 256)))
    ref = np.asarray(jax.jit(jq.int8_matmul_prequant)(jnp.asarray(x), wq, sw))
    got = tq.int8_matmul_prequant(torch.from_numpy(x),
                                  torch.from_numpy(np.array(wq)),
                                  torch.from_numpy(np.array(sw)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_int8_accumulates_exactly_in_int32():
    """+-127 codes over K = 8192: exact integer sums, no f32 emulation."""
    rng = np.random.default_rng(6)
    a = rng.choice([-127, 127], size=(20, 8192)).astype(np.int8)
    b = rng.choice([-127, 127], size=(8192, 16)).astype(np.int8)
    got = tq._int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


def test_int8_affine_matches_jax():
    x, w, b = draw(7, 4, 60, 512), draw(8, 512, 256), draw(9, 256)
    ref = np.asarray(jax.jit(jq.int8_affine)(*map(jnp.asarray, (x, w, b))))
    got = tq.int8_affine(*map(torch.from_numpy, (x, w, b))).numpy()
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=1e-5)
    rel = np.linalg.norm(got - (x @ w + b)) / np.linalg.norm(x @ w + b)
    assert rel < 1.5e-2, rel


def torch_dynamic_conv(p, feat, c, mode):
    m = TorchDynamicConv(feat_size=feat, hidden_dim=c, pro_dim=c,
                         quantize=mode)
    sd = {}
    for name in ("gen1_a", "gen1_b", "gen2_a", "gen2_b", "out_a", "out_b"):
        sd[f"{name}.weight"] = torch.from_numpy(p[name]["kernel"].T.copy())
        sd[f"{name}.bias"] = torch.from_numpy(p[name]["bias"])
    for i in (1, 2, 3):
        sd[f"norm{i}.weight"] = torch.from_numpy(p[f"norm{i}"]["scale"])
        sd[f"norm{i}.bias"] = torch.from_numpy(p[f"norm{i}"]["bias"])
    m.load_state_dict(sd, strict=True)
    return m


@pytest.fixture(scope="module")
def weights():
    return tp.init_variables(tp.jax_cfg(), seed=0)


@pytest.mark.parametrize("mode", MODES)
def test_dynamic_conv_matches_jax(mode, weights):
    """DynamicConv(quantize=mode) against JAX's with ``combined`` from
    ``combine_dynamic_params``: the pre-quantized kernels and scales are
    equal (the JAX second generator's c-major columns un-permuted), the
    output within 1e-4."""
    jcfg = tp.jax_cfg()
    c, feat, a = jcfg.head.fc_hidden_dim, jcfg.head.sample_points, 32
    p = weights["params"]["frame"]["head"]["dyn_head_1"]
    pro, roi = draw(10, 2, a, c), draw(11, 2, a, feat, c)
    comb = combine_dynamic_params(p, c, 2, quantize=mode, c_major=True)
    ref = np.asarray(JaxDynamicConv(feat_size=feat, hidden_dim=c, pro_dim=c,
                                    quantize=mode).apply(
        {"params": tp.jax_tree(p)}, jnp.asarray(pro), jnp.asarray(roi),
        combined=comb, pre_permuted=True))
    tm = torch_dynamic_conv(p, feat, c, mode)
    tcomb = tm.combine_weights()
    d = 2 * c
    unperm = np.argsort(np.arange(d * c).reshape(d, c).T.reshape(-1))
    for chain, entry in comb.items():
        for key in ("wq", "sw", "wq1", "sw1", "wq2", "sw2"):
            if key not in entry:
                continue
            want = np.asarray(entry[key])
            if chain == "gen2" and key in ("wq2", "sw2"):
                want = want[..., unperm]
            np.testing.assert_array_equal(tcomb[chain][key].numpy(), want,
                                          err_msg=f"{chain}.{key}")
    with torch.no_grad():
        got = tm(torch.from_numpy(pro), torch.from_numpy(roi),
                 tcomb).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_quantize_mode_is_checked():
    with pytest.raises(ValueError, match="quantize"):
        TorchDynamicConv(quantize="fp8")
    with pytest.raises(ValueError, match="quantize"):
        dataclasses.replace(tp.torch_cfg(), quantize="int4")


def configs(mode):
    return (dataclasses.replace(tp.jax_cfg(), quantize=mode),
            dataclasses.replace(tp.torch_cfg(), quantize=mode))


def jax_combines(jcfg, variables, mode):
    """The JAX server's eager, pre-permuted quantized combines."""
    h = jcfg.head
    hp = tp.jax_tree(variables)["params"]["frame"]["head"]
    return tuple(combine_dynamic_params(hp[f"dyn_head_{s}"], h.fc_hidden_dim,
                                        h.dyn_dim_factor, quantize=mode,
                                        c_major=True)
                 for s in range(h.refine_layers))


@pytest.mark.parametrize("mode", MODES)
def test_head_stage_outputs_match_jax(mode, weights):
    """One quantized LaneHead frame on injected features and memory:
    per-stage outputs within 1e-1, and 90% of them within 1e-4 (rare
    rounding flips, see the module docstring)."""
    jcfg, tcfg = configs(mode)
    rng = np.random.default_rng(12)
    b = 2
    feats = [rng.normal(size=s).astype(np.float32)
             for s in ((b, 8, 16, 16), (b, 4, 8, 16), (b, 2, 4, 16))]
    s, m, d = jcfg.head.refine_layers, 12, 2 * jcfg.head.fc_hidden_dim
    mem_vals = rng.normal(size=(b, s, m, d)).astype(np.float32)
    mem_mask = rng.uniform(size=(b, m)) < 0.5
    head = JaxLaneHead(jcfg)
    ref = jax.jit(lambda p, f, v, mk, dyn: head.apply(
        {"params": p}, f, v, mk, train=False, dyn_combined=dyn,
        dyn_pre_permuted=True))(
        tp.jax_tree(weights["params"]["frame"]["head"]),
        tuple(map(jnp.asarray, feats)), jnp.asarray(mem_vals),
        jnp.asarray(mem_mask), jax_combines(jcfg, weights, mode))
    tm = tp.torch_model(tcfg, weights)
    with torch.no_grad():
        got = tm.head(tuple(map(torch.from_numpy, feats)),
                      torch.from_numpy(mem_vals), torch.from_numpy(mem_mask))
    for name in ("pred_fir", "pred_sec", "diff", "attn_feat"):
        g, r = tp.to_np(getattr(got, name)), np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-1, err_msg=name)
        assert np.percentile(np.abs(g - r), 90) <= 1e-4, name


@pytest.mark.parametrize("mode", MODES)
def test_clip_matches_jax(mode, weights):
    """A 3-frame clip of 2 streams through the quantized model: keep
    counts and keep slots equal, kept rows and memory within 1e-2."""
    jcfg, tcfg = configs(mode)
    frames = tp.seeded_frames(1, (2, 3, 64, 128, 3))
    jm = JaxPHNet(jcfg)
    jout, jmem = jax.jit(lambda v, f, mem, dyn: jm.apply(
        v, f, None, train=False, initial_memory=mem, dyn_combined=dyn))(
        tp.jax_tree(weights), jnp.asarray(frames), jax_init_memory(jcfg, 2, 3),
        jax_combines(jcfg, weights, mode))
    tm = tp.torch_model(tcfg, weights)
    tout, tmem = tm(torch.from_numpy(frames),
                    initial_memory=torch_init_memory(tcfg, 2, 3))
    np.testing.assert_array_equal(tp.to_np(tout.num_kept),
                                  np.asarray(jout.num_kept))
    np.testing.assert_array_equal(tp.to_np(tout.kept_valid),
                                  np.asarray(jout.kept_valid))
    np.testing.assert_array_equal(tp.to_np(tmem.mask), np.asarray(jmem.mask))
    np.testing.assert_allclose(tp.to_np(tout.kept), np.asarray(jout.kept),
                               rtol=0, atol=MODEL_ATOL)
    np.testing.assert_allclose(tp.to_np(tmem.values),
                               np.asarray(jmem.values), rtol=0,
                               atol=MODEL_ATOL)
    assert int(tout.num_kept.sum()) > 0
