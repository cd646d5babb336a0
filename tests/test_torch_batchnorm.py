"""Training BatchNorm of the port (``phnet_torch/ops/batchnorm.py``)
against the JAX package's ``bn_train_normalize`` and ``FusedBatchNorm``.

The statistics, the forward and the closed-form backward compute the same
float32 formulas in the same order on both sides; the sums over the batch
are the only place where the two may round differently. Measured (two
seeds): in float32 the outputs and gradients agree to 1.5e-6 of their
largest entry; in bf16 ``y`` and ``dx`` (rounded to bf16) are bit-equal,
but for one element of 2880 one bf16 ulp apart in the module test's
draw (a float32 statistic one ulp apart moves a rounding), and the
parameters' float32 sums agree to 9.6e-7 relative. The bounds: float32
within 4e-6 of the largest entry; bf16 ``y`` and ``dx`` bit-equal for
the function, at most 0.1% of the elements one ulp apart for the
module; parameter gradients within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnet_torch.models.resnet import BatchNorm
from phnet_torch.ops.batchnorm import bn_batch_stats, bn_train_normalize
from phnet_tpu.ops.batchnorm import FusedBatchNorm
from phnet_tpu.ops.batchnorm import bn_batch_stats as jax_stats
from phnet_tpu.ops.batchnorm import bn_train_normalize as jax_normalize

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def inputs(seed=0, shape=(3, 10, 12, 8)):
    """NHWC x with a per-channel offset and spread, scale, bias and a
    cotangent."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * rng.uniform(0.5, 3.0, c)
         + rng.normal(size=c)).astype(np.float32)
    scale = (1.0 + rng.normal(0, 0.2, c)).astype(np.float32)
    bias = rng.normal(0, 0.2, c).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return x, scale, bias, g


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def jax_vjp(x, scale, bias, g, jdt):
    """JAX's forward (cast to the compute dtype, as ``FusedBatchNorm``
    does) and its VJP for the cotangent ``g``."""
    def f(x_, s_, b_):
        return jax_normalize(x_, s_, b_).astype(jdt)

    y, vjp = jax.vjp(f, jnp.asarray(x).astype(jdt), jnp.asarray(scale),
                     jnp.asarray(bias))
    dx, ds, db = vjp(jnp.asarray(g).astype(jdt))
    return [np.asarray(a.astype(jnp.float32)) for a in (y, dx, ds, db)]


def torch_vjp(x, scale, bias, g, tdt):
    xt = nchw(x).to(tdt).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    y, _, _ = bn_train_normalize(xt, st, bt)
    y = y.to(tdt)
    y.backward(nchw(g).to(tdt))
    return [to_nhwc(y), to_nhwc(xt.grad), st.grad.numpy(), bt.grad.numpy()]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_batch_stats_match_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    x = inputs()[0]
    jm, jv = jax_stats(jnp.asarray(x).astype(jdt))
    tm, tv = bn_batch_stats(nchw(x).to(tdt))
    assert tm.dtype == tv.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-6,
                               atol=2e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_float32_vjp_matches_jax(seed):
    ref = jax_vjp(*inputs(seed), jnp.float32)
    got = torch_vjp(*inputs(seed), torch.float32)
    for name, g, r in zip(("y", "dx", "dscale", "dbias"), got, ref):
        bound = 4e-6 * np.abs(r).max()
        assert np.abs(g - r).max() <= bound, name


@pytest.mark.parametrize("seed", [0, 1])
def test_bfloat16_vjp_matches_jax(seed):
    """bf16 x and cotangent: y and dx rounded to bf16, bit-equal; the
    parameters' gradients float32."""
    ref = jax_vjp(*inputs(seed), jnp.bfloat16)
    got = torch_vjp(*inputs(seed), torch.bfloat16)
    for name, g, r in zip(("y", "dx"), got[:2], ref[:2]):
        np.testing.assert_array_equal(g, r, err_msg=name)
    for name, g, r in zip(("dscale", "dbias"), got[2:], ref[2:]):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * np.abs(
            r).max(), err_msg=name)


def test_closed_form_equals_autograd_of_the_formula():
    """In float64 the closed form is autograd's gradient of the forward
    (to 1e-12): the same function, differentiated by hand."""
    x, scale, bias, g = inputs(2)
    xt = nchw(x).double().requires_grad_(True)
    st = torch.from_numpy(scale).double().requires_grad_(True)
    bt = torch.from_numpy(bias).double().requires_grad_(True)
    y, _, _ = bn_train_normalize(xt, st, bt)
    got = torch.autograd.grad(y, (xt, st, bt), nchw(g).double())
    xr = nchw(x).double().requires_grad_(True)
    sr = torch.from_numpy(scale).double().requires_grad_(True)
    br = torch.from_numpy(bias).double().requires_grad_(True)
    n = xr.numel() // xr.shape[1]
    mean = xr.sum((0, 2, 3)) / n
    var = (xr * xr).sum((0, 2, 3)) / n - mean * mean
    yr = ((xr - mean[:, None, None]) * (torch.rsqrt(var + 1e-5) * sr)[
        :, None, None] + br[:, None, None])
    ref = torch.autograd.grad(yr, (xr, sr, br), nchw(g).double())
    for a, b in zip(got, ref):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_module_train_step_matches_fused_batchnorm(dtype):
    """The port's ``BatchNorm`` in train mode against the JAX package's
    ``FusedBatchNorm(dtype=...)``: its output in the compute dtype, the
    running statistics float32 and updated alike, the gradients of the
    input (rounded like the output) and of the parameters."""
    tdt, jdt = DTYPES[dtype]
    x, scale, bias, g = inputs(3)
    rng = np.random.default_rng(4)
    c = x.shape[-1]
    stats = {"mean": rng.normal(0, 0.1, c).astype(np.float32),
             "var": (1.0 + rng.uniform(0, 0.5, c)).astype(np.float32)}
    jm = FusedBatchNorm(dtype=jdt)

    def f(p, xx):
        return jm.apply({"params": p, "batch_stats": stats}, xx,
                        use_running_average=False, mutable=["batch_stats"])

    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    y, upd = f(params, jnp.asarray(x).astype(jdt))
    _, vjp = jax.vjp(lambda p, xx: f(p, xx)[0], params,
                     jnp.asarray(x).astype(jdt))
    dp, dx = vjp(jnp.asarray(g).astype(y.dtype))
    tm = BatchNorm(c)
    tm.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "mean": torch.from_numpy(stats["mean"]),
                        "var": torch.from_numpy(stats["var"])})
    tm.train()
    xt = nchw(x).to(tdt).requires_grad_(True)
    yt = tm(xt)
    assert yt.dtype == tdt and tm.mean.dtype == tm.var.dtype == torch.float32
    yt.backward(nchw(g).to(tdt))
    for got, ref in ((to_nhwc(yt), y), (to_nhwc(xt.grad), dx)):
        ref = np.asarray(ref.astype(jnp.float32))
        if dtype == "bfloat16":  # 0-1 of 2880 elements one ulp apart
            off = got != ref
            assert off.mean() <= 1e-3
            assert (np.abs(got - ref)[off]
                    <= 2.0 ** -7 * np.abs(ref)[off]).all()
        else:
            assert np.abs(got - ref).max() <= 4e-6 * np.abs(ref).max()
    for key in ("mean", "var"):
        np.testing.assert_allclose(getattr(tm, key).numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-6)
    for name, grad, key in (("weight", tm.weight.grad, "scale"),
                            ("bias", tm.bias.grad, "bias")):
        ref = np.asarray(dp[key])
        np.testing.assert_allclose(grad.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)
