"""The host plan of the w8 matmul kernel (K3), on the CPU.

``phnet_torch.ops.w8_matmul.w8_plan`` picks the output tile width and the
split-K count of ``csrc/w8_matmul.cu`` from (M, K, N) and the SM count;
the kernel runs only on the card, but its plan and its summation order
are plain Python and are checked here:

- the splits cover the (padded) K exactly, in whole 64-deep units, with no
  overlap and none empty;
- every generator product of the main path (a VIL refine stage, 1 to 8
  streams) gets at least one wave of CTAs on an H100's 132 SMs, or as much
  of one as fits without a second wave, for the reason stated at the
  check;
- no product of the main path is padded, VIL's nor the multi-scale
  OpenLane-V head's (13 a frame, 10 distinct shapes);
- the split sum in the kernel's order (f32 partials of the bf16 operands,
  summed in split order, then scaled) stays within 1e-6 of max |ref| of
  JAX's ``w8_matmul_prequant`` and of ``w8_matmul_pallas(interpret=True)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnet_torch.ops import w8_matmul as tw8
from phnet_tpu.ops import quant as jq
from phnet_tpu.ops.w8_pallas import w8_matmul_pallas

H100_SMS = 132
# the generator products of one VIL refine stage: (name, K, N)
PRODUCTS = (("gen1", 64, 8192), ("gen2_a", 4608, 1024),
            ("gen2_b", 1024, 8192), ("out", 2304, 64))
RAGGED = [(7, 300, 60), (241, 4608, 1024), (960, 72, 8192)]
SHALLOW = [(240, 16, 64), (33, 40, 8192), (5, 10, 3)]  # K < one 64-deep stage
# the distinct (K, N) of the multi-scale OpenLane-V head's 13 products a
# frame (``chip_smoke.w8_products(openlane_multiscale_config())``)
MS_PRODUCTS = ((256, 8192), (3072, 2048), (2048, 8192), (1536, 256),
               (256, 2048), (3072, 512), (512, 2048), (256, 128), (128, 512),
               (3072, 128))
SHAPES = ([(240 * b, k, n) for b in (1, 2, 4, 8) for _, k, n in PRODUCTS]
          + RAGGED + SHALLOW
          + [(240 * b, k, n) for b in (1, 4) for k, n in MS_PRODUCTS])


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_splits_cover_k_exactly(m, k, n):
    plan = tw8.w8_plan(m, k, n, H100_SMS)
    kp = k + plan.pad_k
    ranges = tw8.split_ranges(k, plan)
    assert len(ranges) == plan.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == kp
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0  # contiguous: no gap, no overlap
    for k0, k1 in ranges:
        assert k1 > k0 and k0 % tw8.K_UNIT == 0
    assert kp % tw8.K_ALIGN == 0 and (n + plan.pad_n) % tw8.N_ALIGN == 0
    assert plan.block_n in (64, 128, 256)
    tiles = -(-m // tw8.BLOCK_M) * -(-(n + plan.pad_n) // plan.block_n)
    assert plan.ctas == tiles * plan.splits


@pytest.mark.parametrize("streams", [1, 2, 4, 8])
@pytest.mark.parametrize("name,k,n", PRODUCTS)
def test_main_path_fills_the_card_unpadded(name, k, n, streams):
    """At least one wave of CTAs, or as much of one as the shape allows.

    A CTA of the kernel holds a whole SM (384 threads at up to 168
    registers and 170-210 KB of shared memory), so a grid just past 132
    CTAs runs a second, nearly empty wave. Where the unsplit tiles give
    less than a wave, the plan therefore fills at most one: it splits K
    into as many ranges as fit in 132 CTAs, unless the ranges would get
    shallower than 256 (then one more split is not allowed), and an
    unsplit grid of at least half a wave is taken as it is. So each product
    has at least 132 CTAs, or an unsplit grid of 66 to 131 CTAs (gen1 and
    gen2_b at one stream: 2 row tiles x 64 column tiles of 128), or a split
    grid that one more split would push past 132 CTAs or below 256 deep
    (gen2_a at 1, 2 and 4 streams: 128 CTAs; `out`, N = 64: 9 splits of
    its K = 2304, 18 CTAs at one stream and 72 at four)."""
    m = 240 * streams
    plan = tw8.w8_plan(m, k, n, H100_SMS)
    assert plan.pad_k == 0 and plan.pad_n == 0
    tiles = plan.ctas // plan.splits
    if plan.ctas >= H100_SMS:
        assert plan.splits == 1  # no split past a full wave
        return
    if plan.splits == 1:
        assert 2 * tiles >= H100_SMS
        return
    deepest = k // tw8.MIN_SPLIT_K
    assert plan.ctas + tiles > H100_SMS or plan.splits == deepest, plan


def test_multiscale_products_are_the_presets():
    """``MS_PRODUCTS`` are the products the preset's chains make."""
    import chip_smoke

    cfg = chip_smoke.preset_config("openlane_multiscale_config", "w8")
    products = chip_smoke.w8_products(cfg)
    assert len(products) == 13
    assert {(k, n) for _, k, n in products} == set(MS_PRODUCTS)


@pytest.mark.parametrize("streams", [1, 4])
@pytest.mark.parametrize("k,n", MS_PRODUCTS)
def test_multiscale_products_unpadded(k, n, streams):
    """The multi-scale head's products take the kernel's tensor maps as
    they are (K a multiple of 8, N of 16), in at most one wave of CTAs
    unless unsplit."""
    plan = tw8.w8_plan(240 * streams, k, n, H100_SMS)
    assert plan.pad_k == 0 and plan.pad_n == 0
    assert plan.ctas <= H100_SMS or plan.splits == 1


def _draw(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    wq, sw = jq.quantize_colwise(jnp.asarray(
        (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)))
    return x, wq, sw


@pytest.mark.parametrize("m,k,n", [(240, 4608, 1024), (240, 2304, 64),
                                   (960, 2304, 64), (7, 300, 60),
                                   (241, 1024, 256), (960, 3072, 512),
                                   (960, 3072, 128)])
def test_split_sum_matches_jax(m, k, n):
    """The kernel's summation order in plain PyTorch against JAX's
    ``w8_matmul_prequant``, under the plan the card would take."""
    x, wq, sw = _draw(m, k, n, m + k + n)
    plan = tw8.w8_plan(m, k, n, H100_SMS)
    ref = np.asarray(jq.w8_matmul_prequant(jnp.asarray(x), wq, sw))
    got = tw8.w8_matmul_split_plain(
        torch.from_numpy(x), torch.from_numpy(np.array(wq)),
        torch.from_numpy(np.array(sw)), plan).numpy()
    assert got.dtype == np.float32 and got.shape == (m, n)
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=1e-6)


@pytest.mark.parametrize("splits", [1, 3, 11])
def test_split_sum_matches_pallas_interpret(splits):
    """The same order against the Pallas kernel in interpret mode, at a
    small shape, with 1, 3 and 11 splits of its K = 700."""
    m, k, n = 16, 700, 48
    x, wq, sw = _draw(m, k, n, 7)
    plan = tw8.W8Plan(block_n=64, splits=splits, pad_k=-k % tw8.K_ALIGN,
                      pad_n=-n % tw8.N_ALIGN, ctas=splits)
    ref = np.asarray(w8_matmul_pallas(jnp.asarray(x), wq, sw, interpret=True))
    got = tw8.w8_matmul_split_plain(
        torch.from_numpy(x), torch.from_numpy(np.array(wq)),
        torch.from_numpy(np.array(sw)), plan).numpy()
    assert len(tw8.split_ranges(k, plan)) == splits
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=1e-6)


def test_plan_depends_on_the_sm_count():
    """A card with more SMs takes more splits, and so more CTAs, for the
    same product; each grid fills one wave of its card."""
    small = tw8.w8_plan(240, 4608, 1024, 66)
    large = tw8.w8_plan(240, 4608, 1024, H100_SMS)
    for plan, sms in ((small, 66), (large, H100_SMS)):
        tiles = plan.ctas // plan.splits
        assert sms - tiles < plan.ctas <= sms
    assert small.splits < large.splits
