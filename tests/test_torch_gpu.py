"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where no card is present. On a machine with one
and without JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py`` (the suite's conftest configures JAX; this file
imports no JAX)."""

import os

import numpy as np
import pytest
import torch

from phnet_torch.ops import nms as tnms
from phnet_torch.ops import quant as tq
from phnet_torch.ops import router_chain as trc
from phnet_torch.ops import w8_matmul as tw8

pytestmark = pytest.mark.gpu


def make_problem(seed, a=240, n_offsets=36):
    """Seeded NMS problem (copy of test_nms_pallas.make_problem)."""
    rng = np.random.default_rng(seed)
    proposals = np.zeros((a, 5 + n_offsets), dtype=np.float32)
    proposals[:, 2] = rng.uniform(0, 0.6, a)
    proposals[:, 4] = rng.uniform(0, 40, a)
    base = rng.uniform(0, 700, (a, 1))
    proposals[:, 5:] = base + rng.normal(0, 40, (a, n_offsets))
    scores = rng.uniform(0, 1, a).astype(np.float32)
    return proposals, scores, scores >= 0.3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_lane_nms_kernel_bit_equal_to_plain(cuda):
    probs = [make_problem(s) for s in range(6)]
    p, s, _ = make_problem(9)
    probs += [(p, s, np.zeros_like(s, bool)), (p, s, np.ones_like(s, bool))]
    args = [torch.from_numpy(np.stack([q[i] for q in probs])).to(cuda)
            for i in range(3)]
    launches = tnms.lane_nms.launches
    got = tnms.lane_nms(*args, 50.0, n_offsets=36, top_k=8)
    torch.cuda.synchronize()
    assert tnms.lane_nms.launches == launches + 1
    ref = tnms.lane_nms_plain(*args, 50.0, n_offsets=36, top_k=8)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r.cpu())


NMS_SHAPES = [  # (streams, A, n_offsets, first kind of chip_smoke.NMS_KINDS)
    (1, 240, 36, 0), (1, 240, 36, 6), (4, 240, 36, 4), (8, 240, 36, 0),
    (10, 240, 36, 2),               # the path's shape; every kind
    (4, 32, 12, 0), (8, 32, 12, 0),  # A and O at run time
]


def nms_problem(cuda, streams, a, n_offsets, first, conf, n_lengths=2):
    """``streams`` streams of chip_smoke.NMS_KINDS in turn from ``first``:
    routed [B, A, 5 + n_lengths + O] (VIL's lane layout or OL's), scores
    [B, A] as a strided view (the model's softmax column is one), valid
    [B, A]."""
    import chip_smoke

    kinds = chip_smoke.NMS_KINDS
    routed, scores, valid = chip_smoke.nms_batch(
        torch, [(kinds[(first + i) % len(kinds)], 10 * streams + i)
                for i in range(streams)], a, n_offsets, conf, cuda,
        n_lengths)
    scores = torch.stack([torch.zeros_like(scores), scores], -1)[..., 1]
    return routed, scores, valid


def check_nms_keeps(cuda, streams, a, n_offsets, first, conf, n_lengths=2,
                    top_k=8):
    """Both entries of the kernel against their plain versions, every
    output bit-equal; one launch a call; a second call the same bits."""
    from phnet_torch.config import LaneSpec

    spec = LaneSpec(n_offsets=n_offsets, n_lengths=n_lengths)
    routed, scores, valid = nms_problem(cuda, streams, a, n_offsets, first,
                                        conf, n_lengths)
    args = (routed, scores, spec, 768, conf, 50.0, top_k)
    launches = tnms.lane_nms.launches
    got = tnms.nms_keeps(*args)
    torch.cuda.synchronize()
    assert tnms.lane_nms.launches == launches + 1
    ref = tnms.nms_keeps_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    again = tnms.nms_keeps(*args)
    assert all(torch.equal(g, r) for g, r in zip(again, got))

    props = tnms.nms_proposals_from_predictions(routed, spec, 768)
    nms_args = (props, scores, valid, 50.0, n_offsets, top_k)
    got = tnms.lane_nms(*nms_args)
    torch.cuda.synchronize()
    assert tnms.lane_nms.launches == launches + 3
    for g, r in zip(got, tnms.lane_nms_plain(*nms_args)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("conf", [0.6, 0.0])
@pytest.mark.parametrize("streams,a,n_offsets,first", NMS_SHAPES)
def test_nms_keeps_kernel_bit_equal_to_plain(cuda, streams, a, n_offsets,
                                             first, conf):
    """The kernel through both entries against the plain versions on the
    card, every output bit-equal, on seeded and adversarial streams (tied
    scores, all valid, none valid, fewer valid than top_k, duplicate
    lanes, -0.0 and NaN scores); one launch a call, and a second call
    gives the same bits."""
    check_nms_keeps(cuda, streams, a, n_offsets, first, conf)


@pytest.mark.parametrize("conf", [0.5, 0.0])
@pytest.mark.parametrize("streams,first", [(1, 0), (4, 0), (4, 4), (8, 2),
                                           (10, 6)])
def test_nms_keeps_kernel_bit_equal_to_plain_at_openlane_shape(
        cuda, streams, first, conf):
    """As above at ``openlane_config``'s shape: 240 rows of OL's lane
    layout (one length field, 72 offsets), top_k 4, confidence 0.5."""
    check_nms_keeps(cuda, streams, 240, 72, first, conf, n_lengths=1,
                    top_k=4)


@pytest.mark.parametrize("conf", [0.5, 0.0])
@pytest.mark.parametrize("streams", [1, 4])
def test_nms_keeps_kernel_bit_equal_to_plain_at_propagate_shape(
        cuda, streams, conf):
    """As above at ``openlane_propagate_config``'s shape: 244 rows (240
    anchors and the K = 4 propagated slots, a partial last warp; the
    first stream's last 4 rows dead rows, cls [20, -20] and xs -2), OL's
    lane layout, top_k 4."""
    check_nms_keeps(cuda, streams, 244, 72, 8, conf, n_lengths=1, top_k=4)


def test_nms_keeps_kernel_in_cuda_graph(cuda):
    """The call captured in a CUDA graph: replayed on the captured inputs,
    and on new inputs copied into them, it equals the eager call."""
    check_nms_keeps_in_graph(cuda, 36, 2, 8, 0.6)


def test_nms_keeps_kernel_in_cuda_graph_at_openlane_shape(cuda):
    """As above at ``openlane_config``'s shape (O = 72: the run-time path)."""
    check_nms_keeps_in_graph(cuda, 72, 1, 4, 0.5)


def check_nms_keeps_in_graph(cuda, n_offsets, n_lengths, top_k, conf):
    from phnet_torch.config import LaneSpec

    spec = LaneSpec(n_offsets=n_offsets, n_lengths=n_lengths)
    routed, scores, _ = nms_problem(cuda, 4, 240, n_offsets, 0, conf,
                                    n_lengths)
    routed2, scores2, _ = nms_problem(cuda, 4, 240, n_offsets, 4, conf,
                                      n_lengths)

    def call(r, s):
        return tnms.nms_keeps(r, s, spec, 768, conf, 50.0, top_k)

    want, want2 = call(routed, scores), call(routed2, scores2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(routed, scores)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches = tnms.lane_nms.launches
    with torch.cuda.graph(graph):
        out = call(routed, scores)
    assert tnms.lane_nms.launches == launches + 1
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(g, r) for g, r in zip(out, want))
    routed.copy_(routed2)
    scores.copy_(scores2)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(g, r) for g, r in zip(out, want2))


@pytest.mark.parametrize("streams,a,c,p", [
    (1, 240, 64, 36), (2, 240, 64, 36), (3, 240, 64, 36), (4, 240, 64, 36),
    (8, 240, 64, 36),               # the path's shape; B=3 a partial group
    (1, 32, 16, 12), (4, 32, 16, 12),  # C and P at run time
])
def test_router_chain_kernel_close_to_plain(cuda, streams, a, c, p):
    """Within 1e-4 of the plain version; a second call gives the same
    bits (the LayerNorm partials are summed in a fixed order); one launch
    a call."""
    rng = np.random.default_rng(streams)
    blocks = 4
    f32 = lambda *sh: torch.from_numpy(  # noqa: E731
        rng.normal(size=sh).astype(np.float32)).to(cuda)
    x, taps = f32(streams * a, c, p), f32(a, blocks * 18) * 0.2
    bias, lnp = f32(a, blocks * 2) * 0.1, f32(2 + 4 * blocks, c, p) * 0.1
    lnp[[0] + [2 + 4 * b + o for b in range(blocks) for o in (0, 2)]] += 1.0
    launches = trc.router_chain.launches
    got = trc.router_chain(x, taps, bias, lnp, blocks)
    torch.cuda.synchronize()
    assert trc.router_chain.launches == launches + 1
    ref = trc.router_chain_plain(x, taps, bias, lnp, blocks)
    assert (got - ref).abs().max().item() <= 1e-4
    assert torch.equal(trc.router_chain(x, taps, bias, lnp, blocks), got)
    assert trc.router_chain.launches == launches + 2


def serve_card_and_cpu(preset, ticks=3):
    """A full-width f32 server of the preset, built with torch's TF32 flags
    at their defaults (cuDNN's on), on the card and on the CPU: 2 streams,
    ``ticks`` ticks of seeded frames. Returns {device: (kept [T, 2, K,
    dim], valid [T, 2, K], memory mask)}."""
    import chip_smoke
    from phnet_torch import config
    from phnet_torch.serving import StreamingServer

    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")  # torch's defaults
    torch.backends.cudnn.allow_tf32 = True
    try:
        cfg = getattr(config, preset)()
        weights = chip_smoke.seeded_state_dict(torch, cfg)
        rng = np.random.default_rng(4)
        frames = [{s: rng.normal(size=(cfg.model.img_h, cfg.model.img_w, 3))
                   .astype(np.float32) for s in range(2)}
                  for _ in range(ticks)]
        geometry = (dict(ori_img_h=1080, cut_height=378)
                    if preset == "vil100_config" else {})
        served = {}
        for dev in ("cuda", "cpu"):
            server = StreamingServer(cfg, weights, max_streams=2, device=dev)
            for _ in range(2):
                server.attach(**geometry)
            out = [tuple(t.cpu() for t in server.step_async(f)[:2])
                   for f in frames]
            served[dev] = (torch.stack([k for k, _ in out]),
                           torch.stack([v for _, v in out]),
                           server.memory.mask.cpu())
            assert torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    return served


def test_f32_server_under_default_flags_matches_cpu():
    """A full-width f32 server built with torch's TF32 flags at their
    defaults (cuDNN's on) serves what the CPU serves: the model turns
    TF32 off itself. As ``chip_smoke.py::phase_end_to_end``: every
    tick's kept rows within 1e-3, equal keep masks and memory masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    served = serve_card_and_cpu("vil100_config")
    (kg, vg, mg), (kc, vc, mc) = served["cuda"], served["cpu"]
    assert torch.equal(vg, vc) and torch.equal(mg, mc)
    assert vc.any(), "NMS kept nothing: the check has no rows"
    assert (kg - kc)[vc].abs().max().item() <= 1e-3


@pytest.mark.parametrize("preset", ["openlane_config",
                                    "openlane_multiscale_config"])
def test_openlane_server_on_card_matches_cpu(preset):
    """Both OpenLane-V presets at full width, f32, under torch's default
    TF32 flags: 6 ticks (past the 5-frame ring's wrap), kept rows within
    1e-3 of the CPU's, keep masks and memory masks equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    served = serve_card_and_cpu(preset, ticks=6)
    (kg, vg, mg), (kc, vc, mc) = served["cuda"], served["cpu"]
    assert torch.equal(vg, vc) and torch.equal(mg, mc)
    assert vc.any(), "NMS kept nothing: the check has no rows"
    assert (kg - kc)[vc].abs().max().item() <= 1e-3


@pytest.mark.parametrize("m,k,n", [
    (960, 64, 8192),    # gen1, collapsed, 4 streams x 240 anchors
    (960, 4608, 1024),  # gen2_a, factored
    (960, 1024, 8192),  # gen2_b, factored
    (960, 2304, 64),    # out, collapsed
    (240, 64, 8192),    # the same four at 1 stream
    (240, 4608, 1024),
    (240, 1024, 8192),
    (240, 2304, 64),
    (7, 300, 60),       # every axis ragged (K and N padded)
    (241, 4608, 1024),  # ragged M, split K
    (960, 72, 8192),    # K beyond one stage, not a multiple of it
] + [(m, k, n) for m in (960, 240) for k, n in (  # the multi-scale head's
    (256, 8192), (3072, 2048), (2048, 8192), (1536, 256), (256, 2048),
    (3072, 512), (512, 2048), (256, 128), (128, 512), (3072, 128))])
def test_w8_matmul_kernel_close_to_plain(cuda, m, k, n):
    """Within 1e-5 of max |plain|: the same bf16 operands, f32 sums in
    another order (TF32 off for the plain version's f32 matmul). A second
    call gives the same bits (split-K partials are summed in a fixed
    order), and so does a bf16 x."""
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda)
    wq, sw = tq.quantize_colwise(torch.from_numpy(
        rng.normal(size=(k, n)).astype(np.float32)).to(cuda))
    launches = tw8.w8_matmul.launches
    got = tw8.w8_matmul(x, wq, sw)
    torch.cuda.synchronize()
    assert tw8.w8_matmul.launches == launches + 1
    ref = tq.w8_matmul_prequant(x, wq, sw)
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-5 * scale
    assert torch.equal(tw8.w8_matmul(x, wq, sw), got)
    got_bf16 = tw8.w8_matmul(x.bfloat16(), wq, sw)  # bf16 input, same result
    assert torch.equal(got_bf16, got)
    assert tw8.w8_matmul.launches == launches + 3


@pytest.mark.parametrize("m,k,n", [(960, 4608, 1024), (7, 300, 60)])
def test_int8_product_on_card_equals_cpu(cuda, m, k, n):
    """``torch._int_mm`` on the card (column-major weight; zero-padded
    where M <= 16 or K, N are not multiples of 8) gives the CPU's exact
    int8 product and the same rescaled output."""
    rng = np.random.default_rng(m + k)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    wq, sw = tq.quantize_colwise(torch.from_numpy(
        rng.normal(size=(k, n)).astype(np.float32)))
    ref = tq.int8_matmul_prequant(x, wq, sw)
    got = tq.int8_matmul_prequant(x.to(cuda), tq.int8_weight_layout(
        wq.to(cuda)), sw.to(cuda))
    assert torch.equal(got.cpu(), ref)


def chain_args(cuda, streams=2, a=240, c=64, p=36, blocks=4, grad=False):
    rng = np.random.default_rng(20 + streams)
    f32 = lambda *sh: torch.from_numpy(  # noqa: E731
        rng.normal(size=sh).astype(np.float32)).to(cuda)
    x, taps = f32(streams * a, c, p), f32(a, blocks * 18) * 0.2
    bias, lnp = f32(a, blocks * 2) * 0.1, f32(2 + 4 * blocks, c, p) * 0.1
    lnp[[0] + [2 + 4 * b + o for b in range(blocks) for o in (0, 2)]] += 1.0
    params = [t.requires_grad_(grad) for t in (taps, bias, lnp)]
    return x, params, blocks


def test_router_chain_function_forward_is_the_kernel(cuda):
    """With parameters that want a gradient the wrapper goes through
    ``RouterChainFn``, whose forward is the kernel: one launch, the same
    bits as the launch without autograd."""
    x, params, blocks = chain_args(cuda, grad=True)
    launches = trc.router_chain.launches
    out = trc.router_chain(x, *params, blocks)
    assert out.grad_fn is not None
    assert trc.router_chain.launches == launches + 1
    with torch.no_grad():
        direct = trc.router_chain(x, *params, blocks)
    assert torch.equal(out.detach(), direct)


@pytest.mark.parametrize("streams", [1, 4])
def test_router_chain_function_gradients_match_plain(cuda, streams):
    """The parameter gradients through ``RouterChainFn`` (its backward
    recomputes the plain chain) within 1e-4 of each one's largest entry of
    autograd straight through ``router_chain_plain``."""
    x, params, blocks = chain_args(cuda, streams, grad=True)
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        streams)).to(cuda)
    grads = []
    for fn in (trc.router_chain, trc.router_chain_plain):
        for p in params:
            p.grad = None
        fn(x, *params, blocks).backward(cot)
        grads.append([p.grad.clone() for p in params])
    for g, r, name in zip(*grads, ("taps", "conv_bias", "ln_params")):
        scale = grads[1][0] if name == "conv_bias" else r
        assert (g - r).abs().max().item() <= 1e-4 * scale.abs().max().item()


@pytest.mark.parametrize("streams,group", [(1, 1), (4, 4)])
def test_router_chain_bf16_function_under_autograd(cuda, streams, group):
    """K2's bf16 mode under autograd at the plans of a B = 1 and a B = 4
    bf16 training step (G = 1 and 4): the forward is one launch of the
    bf16 instance (counted apart from the float32 one), the same bits as
    the launch without autograd and a second call; the parameter gradients
    within 1e-4 of each one's largest entry of autograd straight through
    ``router_chain_plain(bf16=True)``, which its backward recomputes."""
    x, params, blocks = chain_args(cuda, streams, grad=True)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert trc.router_plan(x.shape[0], 240, n_sms).group == group
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        streams)).to(cuda).bfloat16()
    before = (trc.router_chain.launches, trc.router_chain.launches_bf16)
    out = trc.router_chain(x, *params, blocks, bf16=True)
    assert out.dtype == torch.bfloat16 and out.grad_fn is not None
    assert (trc.router_chain.launches,
            trc.router_chain.launches_bf16) == (before[0], before[1] + 1)
    with torch.no_grad():
        direct = trc.router_chain(x, *params, blocks, bf16=True)
        again = trc.router_chain(x, *params, blocks, bf16=True)
    assert torch.equal(out.detach(), direct) and torch.equal(direct, again)
    grads = []
    for fn in (trc.router_chain, trc.router_chain_plain):
        for p in params:
            p.grad = None
        fn(x, *params, blocks, bf16=True).backward(cot)
        grads.append([p.grad.clone() for p in params])
    for g, r, name in zip(*grads, ("taps", "conv_bias", "ln_params")):
        assert g.dtype == torch.float32
        scale = grads[1][0] if name == "conv_bias" else r
        assert (g - r).abs().max().item() <= 1e-4 * scale.abs().max().item()


@pytest.mark.parametrize("n,r,c", [(48, 8, 240), (16, 4, 32)])
def test_hungarian_on_card_bit_equal_to_cpu(cuda, n, r, c):
    from phnet_torch.ops.hungarian import hungarian_assign

    rng = np.random.default_rng(r)
    cost = rng.normal(size=(n, r, c)).astype(np.float32)
    cost[: n // 4] = np.round(cost[: n // 4] * 2) / 2  # ties
    valid = torch.from_numpy(rng.uniform(size=(n, r)) < 0.7)
    cost = torch.from_numpy(cost)
    got = hungarian_assign(cost.to(cuda), valid.to(cuda)).cpu()
    assert torch.equal(got, hungarian_assign(cost, valid))


def small_train_config(dropout=0.0):
    from phnet_torch import config as c

    model = c.ModelConfig(
        img_h=64, img_w=128, lane=c.LaneSpec(n_offsets=12, n_lengths=2),
        backbone=c.BackboneConfig(in_channels=(8, 16, 24, 32)),
        neck=c.NeckConfig(in_channels=(16, 24, 32), out_channels=16),
        head=c.HeadConfig(num_priors=32, sample_points=8, fc_hidden_dim=16,
                          prior_feat_channels=16, decoder_ffn_dim=32,
                          decoder_dropout=dropout),
        memory=c.MemoryConfig(window=0), max_lanes=4)
    return c.Config(model=model)


def test_small_train_step_on_card_matches_cpu():
    """One training step of the small configuration (2 synthetic clips of 3
    frames), card against CPU, with torch's TF32 flags at their defaults
    (cuDNN's on): the step runs its forward and its backward in float32
    itself. Loss within 1e-4 relative, gradient norm 1e-3, the sampled
    gradient leaves 1e-2 of their largest entry (BatchNorm over 6 small
    frames amplifies rounding), the matches equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke

    cfg = small_train_config()
    frames, labels = chip_smoke.synthetic_batch(torch, cfg, 2, 3)
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")  # torch's defaults
    torch.backends.cudnn.allow_tf32 = True
    try:
        runs = {dev: chip_smoke.grad_run(torch, cfg, frames, labels, dev)
                for dev in ("cuda", "cpu")}
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    g, c = runs["cuda"], runs["cpu"]
    assert abs(g["loss"] - c["loss"]) <= 1e-4 * abs(c["loss"])
    assert abs(g["grad_norm"] - c["grad_norm"]) <= 1e-3 * c["grad_norm"]
    assert torch.equal(g["matched"], c["matched"])
    for name, ref in c["grads"].items():
        err = (g["grads"][name] - ref).abs().max().item()
        assert err <= 1e-2 * ref.abs().max().item() + 1e-6, name


def test_train_step_makes_no_host_sync(cuda):
    """A training step on the card (forward, Hungarian solves, criterion,
    backward, AdamW) under ``set_sync_debug_mode("error")``: after one
    warm-up step it never waits for the card."""
    import chip_smoke
    from phnet_torch.losses import LaneCriterion
    from phnet_torch.train.state import create_train_state
    from phnet_torch.train.step import make_train_step

    cfg = small_train_config(dropout=0.1)
    frames, labels = chip_smoke.synthetic_batch(torch, cfg, 1, 3)
    frames, labels = frames.to(cuda), labels.to(cuda)
    state = create_train_state(cfg, 100, cuda, seed=0)
    step = make_train_step(LaneCriterion(cfg.model, cfg.train.loss))
    state, _ = step(state, frames, labels, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, frames, labels, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(metrics["loss"].item())


@pytest.mark.parametrize("streams,a,c,p", [
    (1, 240, 64, 36), (3, 240, 64, 36), (4, 240, 64, 36), (9, 240, 64, 36),
    (16, 240, 64, 36),              # the path's shape, above 8 streams too
    (4, 32, 16, 12),                # C and P at run time
])
def test_router_chain_bf16_kernel_close_to_plain(cuda, streams, a, c, p):
    """The chain's bf16 mode against ``router_chain_plain(bf16=True)``: a
    bf16 output, within 2**-6 of max |plain| with under 1% of the elements
    differing (``chip_smoke.py::phase_router_bf16``); a second call gives
    the same bits; one launch a call, counted apart from the float32
    instance's."""
    rng = np.random.default_rng(streams + 100)
    blocks = 4
    f32 = lambda *sh: torch.from_numpy(  # noqa: E731
        rng.normal(size=sh).astype(np.float32)).to(cuda)
    x, taps = f32(streams * a, c, p), f32(a, blocks * 18) * 0.2
    bias, lnp = f32(a, blocks * 2) * 0.1, f32(2 + 4 * blocks, c, p) * 0.1
    lnp[[0] + [2 + 4 * b + o for b in range(blocks) for o in (0, 2)]] += 1.0
    before = (trc.router_chain.launches, trc.router_chain.launches_bf16)
    got = trc.router_chain(x, taps, bias, lnp, blocks, bf16=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert (trc.router_chain.launches,
            trc.router_chain.launches_bf16) == (before[0], before[1] + 1)
    ref = trc.router_chain_plain(x, taps, bias, lnp, blocks, bf16=True)
    d = (got.float() - ref.float()).abs()
    assert d.max().item() <= ref.float().abs().max().item() / 64
    assert (d > 0).float().mean().item() < 0.01
    assert torch.equal(trc.router_chain(x, taps, bias, lnp, blocks,
                                        bf16=True), got)


@pytest.mark.parametrize("mode", ["none", "w8"])
def test_bf16_end_to_end_card_matches_cpu(mode):
    """The full-width VIL model in bf16, a 2-frame clip on the card and on
    the CPU (``chip_smoke.py::phase_end_to_end``: routed predictions
    within twice the CPU's own one-ulp spread, keep counts equal where
    that spread leaves them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke

    card = torch.cuda.get_device_name(0)
    weights = chip_smoke.seeded_state_dict(
        torch, chip_smoke.preset_config("vil100_config"))
    chip_smoke.phase_end_to_end(torch, card, weights, mode,
                                compute_dtype="bfloat16")


def test_server_above_8_streams_runs_bf16_chain(cuda):
    """A full-width f32 server of 9 streams resolves the router chain to
    its bf16 mode, as the JAX server does: one tick launches it three
    times and the float32 instance never; the chain-pinned clip holds card
    against CPU (``chip_smoke.py::phase_end_to_end``)."""
    import chip_smoke
    from phnet_torch.config import vil100_config
    from phnet_torch.serving import StreamingServer

    cfg = vil100_config()
    weights = chip_smoke.seeded_state_dict(torch, cfg)
    server = StreamingServer(cfg, weights, max_streams=9)
    assert server.mcfg.head.router_chain_bf16 is True
    for _ in range(9):
        server.attach()
    rng = np.random.default_rng(4)
    frames = {s: rng.normal(size=(cfg.model.img_h, cfg.model.img_w, 3))
              .astype(np.float32) for s in range(9)}
    before = (trc.router_chain.launches, trc.router_chain.launches_bf16)
    kept, valid, _ = server.step_async(frames)
    torch.cuda.synchronize()
    assert (trc.router_chain.launches,
            trc.router_chain.launches_bf16) == (before[0], before[1] + 3)
    assert torch.isfinite(kept).all() and valid.any()
    chip_smoke.phase_end_to_end(torch, torch.cuda.get_device_name(0),
                                weights, chain_bf16=True)


# -- the evaluation path's decode on the card (nvJPEG) ----------------------

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_eval")


def test_colour_path_and_resize_on_card_equal_cpu(cuda):
    """``ycc_to_rgb`` (integer arithmetic) bit-equal on the card and on the
    CPU from the same planes, and ``resize_normalize`` likewise (float32
    elementwise operations, one PyTorch operation each)."""
    from phnet_torch.data import native_loader as nl

    rng = np.random.default_rng(0)
    h, w = 721, 1281
    planes = [rng.integers(0, 256, s, dtype=np.uint8)
              for s in ((h, w), ((h + 1) // 2, (w + 1) // 2),
                        ((h + 1) // 2, (w + 1) // 2))]
    cpu = nl.ycc_to_rgb([torch.from_numpy(p) for p in planes])
    card = nl.ycc_to_rgb([torch.from_numpy(p).to(cuda) for p in planes])
    assert torch.equal(card.cpu(), cpu)
    u8 = torch.stack([cpu, cpu.flip(0)])
    want = nl.resize_normalize(u8, 252, 384, 768)
    got = nl.resize_normalize(u8.to(cuda), 252, 384, 768)
    assert torch.equal(got.cpu(), want)


def test_nvjpeg_decode_close_to_libjpeg(cuda):
    """The card's decode of the fixture's frames against their libjpeg
    decode (``decoded_u8.npz``), within ``chip_smoke``'s bounds."""
    import chip_smoke
    from phnet_torch.data.native_loader import NvJpegDecoder

    ref = np.load(os.path.join(FIXTURE, "decoded_u8.npz"))
    s = int(ref["stride"])
    with NvJpegDecoder() as dec:
        for key in ("vil", "ol"):
            u8 = dec.decode([os.path.join(FIXTURE, f)
                             for f in ref[key + "_files"]], cuda)
            diff = np.abs(u8[:, ::s, ::s].cpu().numpy().astype(np.int16)
                          - ref[key])
            assert diff.max() <= chip_smoke.NVJPEG_MAX_LEVELS
            assert diff.mean() <= chip_smoke.NVJPEG_MEAN_LEVELS
