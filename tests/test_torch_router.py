"""The router chain of the port (plain version) against the JAX chain
(``_ln`` fast variance + ``_conv3x3``), against ``fused_router_blocks`` in
interpret mode, and the whole router against ``AdaptiveRouter``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnet_torch.models.router import AdaptiveRouter as TorchRouter
from phnet_torch.ops import router_chain as trc
from phnet_tpu.models.router import AdaptiveRouter as JaxRouter
from phnet_tpu.ops.router_pallas import _conv3x3, _ln, fused_router_blocks

A, C, P, BLOCKS = 32, 16, 12, 4


def jax_chain(feats, taps, biases, lnp):
    x = _ln(feats, lnp[0], lnp[1])
    for b in range(BLOCKS):
        o = 2 + 4 * b
        y = _conv3x3(x, taps[:, 18 * b:18 * b + 9], biases[:, 2 * b])
        y = jnp.maximum(_ln(y, lnp[o], lnp[o + 1]), 0.0)
        y = _conv3x3(y, taps[:, 18 * b + 9:18 * b + 18], biases[:, 2 * b + 1])
        x = jnp.maximum(_ln(y, lnp[o + 2], lnp[o + 3]) + x, 0.0)
    return x


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    lnp = f32(2 + 4 * BLOCKS, C, P) * 0.1  # LN scales near 1, biases near 0
    lnp[[0] + [2 + 4 * b + o for b in range(BLOCKS) for o in (0, 2)]] += 1.0
    return (f32(A, C, P), f32(A, BLOCKS * 18) * 0.2,
            f32(A, BLOCKS * 2) * 0.1, lnp)


def test_chain_plain_matches_jax_chain(problem):
    """Tolerance 1e-5: same fast-variance LayerNorm and tap order, sums in
    another order."""
    ref = np.asarray(jax_chain(*map(jnp.asarray, problem)))
    launches = trc.router_chain.launches
    got = trc.router_chain(*map(torch.from_numpy, problem), BLOCKS).numpy()
    assert trc.router_chain.launches == launches  # CPU: plain version
    assert np.abs(got - ref).max() <= 1e-5


def test_chain_plain_matches_pallas_interpret(problem):
    """The bounds of tests/test_router_pallas.py (the TPU kernel's own
    two-pass LayerNorm)."""
    ref = np.asarray(fused_router_blocks(*map(jnp.asarray, problem),
                                         blocks=BLOCKS, interpret=True))
    got = trc.router_chain_plain(*map(torch.from_numpy, problem),
                                 BLOCKS).numpy()
    diff = np.abs(got - ref)
    assert diff.mean() < 0.01, diff.mean()
    assert diff.max() < 0.5, diff.max()


def test_chain_repeats_anchor_params_over_streams(problem):
    """Planes of stream b use the params of anchor n % A."""
    feats, taps, biases, lnp = map(torch.from_numpy, problem)
    two = torch.cat([feats, feats.flip(0)])
    out = trc.router_chain_plain(two, taps, biases, lnp, BLOCKS)
    torch.testing.assert_close(
        out[:A], trc.router_chain_plain(feats, taps, biases, lnp, BLOCKS),
        rtol=0, atol=0)


def test_router_scores_match_jax():
    """Whole router (chain + MLP + sigmoid), tolerance 1e-5."""
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(2, A, C, P)).astype(np.float32)
    jr = JaxRouter(num_anchors=A, channels=C, points=P)
    v = jr.init(jax.random.key(0), jnp.asarray(feats))
    params = jax.tree_util.tree_map(np.array, v["params"])
    params["conv_bias"] = rng.normal(0, 0.1, params["conv_bias"].shape
                                     ).astype(np.float32)
    ref = np.asarray(jr.apply({"params": params}, jnp.asarray(feats)))
    tr = TorchRouter(A, C, P)
    tr.load_state_dict({
        "taps": torch.from_numpy(params["taps"]),
        "conv_bias": torch.from_numpy(params["conv_bias"]),
        "ln_params": torch.from_numpy(params["ln_params"]),
        "dense0.weight": torch.from_numpy(params["Dense_0"]["kernel"].T.copy()),
        "dense0.bias": torch.from_numpy(params["Dense_0"]["bias"]),
        "dense1.weight": torch.from_numpy(params["Dense_1"]["kernel"].T.copy()),
        "dense1.bias": torch.from_numpy(params["Dense_1"]["bias"]),
    })
    with torch.no_grad():
        got = tr(torch.from_numpy(feats)).numpy()
    assert got.shape == ref.shape == (2, A, 1)
    assert np.abs(got - ref).max() <= 1e-5
    assert got.min() >= 0.5


@pytest.mark.parametrize("streams", [1, 2])
def test_chain_gradient_matches_jax(problem, streams):
    """The chain under autograd (``RouterChainFn``: on the CPU the plain
    chain forward, its recomputation differentiated backward) against
    ``jax.vjp`` of the JAX chain: the gradients of taps, conv biases and
    LayerNorm parameters (summed over the streams that share them) and of
    x, within 1e-5 of each one's largest entry. The conv biases' gradient
    is zero up to rounding (the LayerNorm after each conv cancels a
    per-plane constant): both sides' are rounding noise of sums as large
    as the taps' gradient's, so its bound is 1e-5 of that."""
    feats, taps, biases, lnp = problem
    x = np.concatenate([feats] * streams) * np.linspace(
        0.5, 1.5, streams).repeat(A)[:, None, None].astype(np.float32)
    cot = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jchain(xx, t, b, l):
        return jax_chain(xx, jnp.tile(t, (streams, 1)),
                         jnp.tile(b, (streams, 1)), l)

    _, vjp = jax.vjp(jchain, *map(jnp.asarray, (x, taps, biases, lnp)))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    inputs = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (x, taps, biases, lnp)]
    out = trc.router_chain(*inputs, BLOCKS)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(cot))
    for t, r, name in zip(inputs, ref, ("x", "taps", "conv_bias",
                                        "ln_params")):
        scale = ref[1] if name == "conv_bias" else r
        bound = 1e-5 * np.abs(scale).max()
        assert np.abs(t.grad.numpy() - r).max() <= bound, name


def test_chain_function_matches_plain_autograd(problem):
    """The Function's gradients equal autograd straight through
    ``router_chain_plain`` (what its backward recomputes), bit for bit;
    x detached, as the router passes it."""
    feats, taps, biases, lnp = map(torch.from_numpy, problem)
    grads = []
    for fn in (trc.router_chain, trc.router_chain_plain):
        params = [p.clone().requires_grad_() for p in (taps, biases, lnp)]
        fn(feats, *params, BLOCKS).square().sum().backward()
        grads.append([p.grad for p in params])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
