"""How the router chain kernel groups its planes (``router_plan``), on the
CPU: every plane once, one anchor a CTA, at most 4 planes a CTA, one wave
up to 4 streams; and the chain of a CTA's planes, computed with its
anchor's taps alone, is the chain of the whole call."""

import numpy as np
import pytest
import torch

from phnet_torch.ops import router_chain as trc

SMS = 132  # an H100 SXM


@pytest.mark.parametrize("anchors", [240, 32])
@pytest.mark.parametrize("streams", range(1, 9))
def test_plan_covers_each_plane_once_in_one_wave(streams, anchors):
    n = streams * anchors
    plan = trc.router_plan(n, anchors, SMS)
    planes = trc.plan_planes(plan, n)
    assert plan.group in trc.GROUPS and plan.group <= 4
    assert tuple(planes.shape) == (anchors, plan.grid[1], plan.group)
    live = planes[planes >= 0]
    assert torch.equal(live.sort().values, torch.arange(n))
    for a in range(anchors):  # the planes of a CTA share its anchor
        assert bool((planes[a][planes[a] >= 0] % anchors == a).all())
    ctas = plan.grid[0] * plan.grid[1]
    if streams <= 4:
        assert ctas <= trc.CTAS_PER_SM * SMS
    assert plan.threads == 288 and plan.threads % 32 == 0


def test_plan_groups_as_the_design_says():
    """At 240 anchors: G = 1, 2, 4, 4 for B = 1..4, 240 CTAs each; B = 3
    leaves its group partial; B = 8 takes two groups of 4."""
    got = {b: trc.router_plan(240 * b, 240, SMS) for b in (1, 2, 3, 4, 8)}
    assert {b: (p.group, p.grid) for b, p in got.items()} == {
        1: (1, (240, 1)), 2: (2, (240, 1)), 3: (4, (240, 1)),
        4: (4, (240, 1)), 8: (4, (240, 2))}
    assert (trc.plan_planes(got[3], 720)[:, 0, 3] == -1).all()
    assert trc.router_plan(4 * 32, 32, SMS, 16, 12).threads == 32


@pytest.mark.parametrize("streams", [3, 4])
def test_chain_by_plan_groups_equals_whole_call(streams):
    """The plain chain on each CTA's planes, reordered and run with that
    CTA's anchor alone, equals the unordered call at the CPU geometry
    (A=32, C=16, P=12), bit for bit: the plan pairs each plane with its
    own anchor's parameters."""
    a, c, p, blocks = 32, 16, 12, 4
    rng = np.random.default_rng(streams)
    f32 = lambda *sh: torch.from_numpy(  # noqa: E731
        rng.normal(size=sh).astype(np.float32))
    x, taps = f32(streams * a, c, p), f32(a, blocks * 18) * 0.2
    bias, lnp = f32(a, blocks * 2) * 0.1, f32(2 + 4 * blocks, c, p) * 0.1
    whole = trc.router_chain_plain(x, taps, bias, lnp, blocks)
    plan = trc.router_plan(streams * a, a, 1, c, p)  # one SM: groups of 4
    assert plan.group == 4
    planes = trc.plan_planes(plan, streams * a)
    got = torch.full_like(whole, float("nan"))
    for anchor in range(a):
        for idx in planes[anchor]:
            idx = idx[idx >= 0]
            got[idx] = trc.router_chain_plain(
                x[idx], taps[anchor:anchor + 1], bias[anchor:anchor + 1],
                lnp, blocks)
    assert torch.equal(got, whole)
