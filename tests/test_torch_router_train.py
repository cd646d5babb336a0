"""The router in training: K2's bf16 mode under autograd
(``RouterChainFn(bf16=True)``, on the CPU the plain chain recomputed and
differentiated) against JAX's autodiff of its bf16 chain, and the rule
that picks the chain's mode (``phnet_tpu/models/router.py:148-149``).

The JAX chain is compiled without excess precision (``exact_jit``): it
rounds every product and sum of a 3x3 to bf16, and each cast rounds the
cotangent. The port rounds each 3x3 once (``router_chain_plain``'s
documented rounding points), and its backward rounds the cotangent at
those points. The chain's bf16 gradient is mostly rounding noise of four
LayerNorm blocks: JAX's own bf16 gradient is 17-49% of its largest entry
from its float32 one. Tolerances, measured on two seeds of
``test_torch_bf16.router_inputs`` (2 streams of 32 anchors, [16, 12]
planes, 4 blocks) with a random cotangent:

* taps and LayerNorm parameters: within twice the port's own one-ulp
  spread (its gradient when each input element moves by -1, 0 or +1 bf16
  ulp, the largest change over three such copies): measured 0.64-1.72x;
* conv biases, whose gradient is zero up to rounding (each conv's
  LayerNorm cancels a per-plane constant): within twice JAX's own
  float32-vs-bf16 distance, measured 1.0x (1.4e-2 and 2.3e-2 of the taps'
  largest gradient).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phnet_torch.config as tcfg
import torch_parity as tp
from phnet_torch.ops import router_chain as trc
from phnet_tpu.ops.router_pallas import _conv3x3, _ln
from test_torch_bf16 import exact_jit, one_ulp, router_inputs, torch_router

PARAMS = ("taps", "conv_bias", "ln_params")
ULP_SEEDS = (5, 6, 7)


def jax_chain(x, taps, bias, lnp, dt):
    """The chain of ``phnet_tpu/models/router.py`` in ``dt`` (the taps
    tiled over the streams in float32, then cast)."""
    b, a, c, p = x.shape
    taps_b = jnp.tile(taps, (b, 1)).astype(dt)
    bias_b = jnp.tile(bias, (b, 1)).astype(dt)
    x = _ln(x.reshape(b * a, c, p), lnp[0], lnp[1]).astype(dt)
    for blk in range(taps.shape[1] // 18):
        o = 2 + 4 * blk
        y = _conv3x3(x, taps_b[:, 18 * blk:18 * blk + 9],
                     bias_b[:, 2 * blk]).astype(dt)
        y = jnp.maximum(_ln(y, lnp[o], lnp[o + 1]).astype(dt), 0.0)
        y = _conv3x3(y, taps_b[:, 18 * blk + 9:18 * blk + 18],
                     bias_b[:, 2 * blk + 1]).astype(dt)
        y = _ln(y, lnp[o + 2], lnp[o + 3]).astype(dt)
        x = jnp.maximum(y + x, 0.0).astype(dt)
    return x


def jax_grads(feats, params, cot, dt):
    """JAX's parameter gradients of its chain in ``dt`` for ``cot``."""
    jit = exact_jit if dt == jnp.bfloat16 else jax.jit

    @jit
    def vjp(t, b, lnp):
        _, fn = jax.vjp(lambda *a: jax_chain(jnp.asarray(feats), *a, dt),
                        t, b, lnp)
        return fn(jnp.asarray(cot).astype(dt))

    return [np.asarray(g, np.float64)
            for g in vjp(*(jnp.asarray(params[k]) for k in PARAMS))]


def port_grads(feats, params, cot):
    """The port's parameter gradients of its bf16 chain under autograd."""
    ins = [torch.from_numpy(params[k]).requires_grad_() for k in PARAMS]
    x = torch.from_numpy(feats.reshape(-1, *feats.shape[2:]))
    out = trc.router_chain(x, *ins, 4, bf16=True)
    assert out.dtype == torch.bfloat16 and out.grad_fn is not None
    out.backward(torch.from_numpy(cot).bfloat16())
    return [t.grad.double().numpy() for t in ins]


@pytest.mark.parametrize("seed", [7, 8])
def test_bf16_chain_gradient_matches_jax(seed):
    feats, params = router_inputs(seed)
    n = feats.shape[0] * feats.shape[1]
    cot = np.random.default_rng(seed + 100).normal(
        size=(n,) + feats.shape[2:]).astype(np.float32)
    ref = jax_grads(feats, params, cot, jnp.bfloat16)
    ref32 = jax_grads(feats, params, cot, jnp.float32)
    got = port_grads(feats, params, cot)
    spread = [0.0] * 3
    for s in ULP_SEEDS:
        for i, g in enumerate(port_grads(one_ulp(feats, s), params, cot)):
            spread[i] = max(spread[i], np.abs(g - got[i]).max())
    for i, name in enumerate(PARAMS):
        gap = np.abs(got[i] - ref[i]).max()
        if name == "conv_bias":
            assert gap <= 2 * np.abs(ref32[i] - ref[i]).max(), name
        else:
            assert gap <= 2 * spread[i], (name, gap, spread[i])


def test_bf16_chain_backward_is_the_plain_chain_differentiated():
    """``RouterChainFn``'s bf16 gradients equal autograd straight through
    ``router_chain_plain(bf16=True)`` bit for bit (its backward recomputes
    that chain), and the plain chain's cotangent is rounded to bf16 at the
    chain's output."""
    feats, params = router_inputs(seed=9)
    x = torch.from_numpy(feats.reshape(-1, *feats.shape[2:]))
    grads = []
    for fn in (trc.router_chain, trc.router_chain_plain):
        ins = [torch.from_numpy(params[k]).requires_grad_() for k in PARAMS]
        out = fn(x, *ins, 4, bf16=True)
        assert out.dtype == torch.bfloat16
        out.float().square().sum().backward()
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def chain_modes(monkeypatch):
    """Record the mode of each chain the router runs."""
    modes = []
    real = trc.router_chain_plain

    def spy(*args, **kw):
        modes.append(bool(args[5] if len(args) > 5 else kw.get("bf16")))
        return real(*args, **kw)

    monkeypatch.setattr(trc, "router_chain_plain", spy)
    return modes


@pytest.mark.parametrize("dtype,train_chain_f32,train,want", [
    (None, False, True, False),
    (torch.bfloat16, False, True, True),
    (torch.bfloat16, True, True, False),
    (torch.bfloat16, False, False, False),
    (None, True, False, False),
])
def test_chain_mode_rule(monkeypatch, dtype, train_chain_f32, train, want):
    """In training the chain follows the compute dtype unless
    ``train_chain_f32``; at inference it is float32 (``chain_bf16`` off).
    Under autograd the backward recomputes the chain in the same mode."""
    feats, params = router_inputs(seed=11)
    router = torch_router(params, dtype=dtype,
                          train_chain_f32=train_chain_f32)
    router.train(train)
    modes = chain_modes(monkeypatch)
    out = router(torch.from_numpy(feats))
    assert out.dtype == torch.float32
    if train:
        out.sum().backward()
        assert router.taps.grad is not None
    assert modes and set(modes) == {want}


def test_head_config_carries_the_flag():
    """``HeadConfig.router_train_chain_f32`` (default False, as the JAX
    package's) reaches every router of the head."""
    assert tcfg.HeadConfig().router_train_chain_f32 is False
    m = dataclasses.replace(tp.torch_cfg(), compute_dtype="bfloat16")
    m = dataclasses.replace(m, head=dataclasses.replace(
        m.head, router_train_chain_f32=True))
    model = tp.torch_model(m, tp.init_variables(tp.jax_cfg(), seed=0))
    assert [r.train_chain_f32 for r in model.head.routers] == [True] * 3
