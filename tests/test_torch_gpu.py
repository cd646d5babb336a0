"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where no card is present. On a machine with one
and without JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py`` (the suite's conftest configures JAX; this file
imports no JAX)."""

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


def nms_problem(cuda, streams, a, n_offsets, first, conf):
    """``streams`` streams of chip_smoke.NMS_KINDS in turn from ``first``:
    routed [B, A, 7 + O], scores [B, A] as a strided view (the model's
    softmax column is one), valid [B, A]."""
    import chip_smoke

    kinds = chip_smoke.NMS_KINDS
    routed, scores, valid = chip_smoke.nms_batch(
        torch, [(kinds[(first + i) % len(kinds)], 10 * streams + i)
                for i in range(streams)], a, n_offsets, conf, cuda)
    scores = torch.stack([torch.zeros_like(scores), scores], -1)[..., 1]
    return routed, scores, valid


@pytest.mark.parametrize("conf", [0.6, 0.0])
@pytest.mark.parametrize("streams,a,n_offsets,first", NMS_SHAPES)
def test_nms_keeps_kernel_bit_equal_to_plain(cuda, streams, a, n_offsets,
                                             first, conf):
    """The kernel through both entries against the plain versions on the
    card, every output bit-equal, on seeded and adversarial streams (tied
    scores, all valid, none valid, fewer valid than top_k, duplicate
    lanes, -0.0 and NaN scores); one launch a call, and a second call
    gives the same bits."""
    from phnet_torch.config import LaneSpec

    spec = LaneSpec(n_offsets=n_offsets)
    routed, scores, valid = nms_problem(cuda, streams, a, n_offsets, first,
                                        conf)
    args = (routed, scores, spec, 768, conf, 50.0, 8)
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
    nms_args = (props, scores, valid, 50.0, n_offsets, 8)
    got = tnms.lane_nms(*nms_args)
    torch.cuda.synchronize()
    assert tnms.lane_nms.launches == launches + 3
    for g, r in zip(got, tnms.lane_nms_plain(*nms_args)):
        assert torch.equal(g, r)


def test_nms_keeps_kernel_in_cuda_graph(cuda):
    """The call captured in a CUDA graph: replayed on the captured inputs,
    and on new inputs copied into them, it equals the eager call."""
    from phnet_torch.config import LaneSpec

    spec = LaneSpec(n_offsets=36)
    routed, scores, _ = nms_problem(cuda, 4, 240, 36, 0, 0.6)
    routed2, scores2, _ = nms_problem(cuda, 4, 240, 36, 4, 0.6)

    def call(r, s):
        return tnms.nms_keeps(r, s, spec, 768, 0.6, 50.0, 8)

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


def test_f32_server_under_default_flags_matches_cpu():
    """A full-width f32 server built with torch's TF32 flags at their
    defaults (cuDNN's on) serves what the CPU serves: the model turns
    TF32 off itself. As ``chip_smoke.py::phase_end_to_end``: every
    tick's kept rows within 1e-3, equal keep masks and memory masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import chip_smoke
    from phnet_torch.config import vil100_config
    from phnet_torch.serving import StreamingServer

    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")  # torch's defaults
    torch.backends.cudnn.allow_tf32 = True
    try:
        cfg = vil100_config()
        weights = chip_smoke.seeded_state_dict(torch, cfg)
        rng = np.random.default_rng(4)
        ticks = [{s: rng.normal(size=(cfg.model.img_h, cfg.model.img_w, 3))
                  .astype(np.float32) for s in range(2)} for _ in range(3)]
        served = {}
        for dev in ("cuda", "cpu"):
            server = StreamingServer(cfg, weights, max_streams=2, device=dev)
            for _ in range(2):
                server.attach(ori_img_h=1080, cut_height=378)
            out = [tuple(t.cpu() for t in server.step_async(frames)[:2])
                   for frames in ticks]
            served[dev] = (torch.stack([k for k, _ in out]),
                           torch.stack([v for _, v in out]),
                           server.memory.mask.cpu())
            assert torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
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
])
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
