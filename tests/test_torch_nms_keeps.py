"""The keeps of lane NMS without a sort: the pick algorithm of the kernel
``phnet_torch/csrc/lane_nms.cu``, modelled here in PyTorch, against the
port's plain version and the JAX package's ``lane_nms`` and
``lane_nms_pallas`` (interpret mode); the port's ``nms_keeps_plain``
against the JAX chain of ``PHNet._nms_keeps``; and ``PHNet.nms_keeps`` on
CPU tensors, which launches no kernel. All bit-equal, at VIL's shape (36
offsets, top_k 8, its lane layout) and at OpenLane's (72 offsets, top_k
4, confidence 0.5, one length field)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnet_torch.config import LaneSpec as TorchLaneSpec
from phnet_torch.models import PHNet
from phnet_torch.ops import nms as tnms
from phnet_tpu.config import LaneSpec as JaxLaneSpec
from phnet_tpu.ops import lane_nms, nms_proposals_from_predictions
from phnet_tpu.ops.nms_pallas import lane_nms_pallas

import chip_smoke
from torch_parity import torch_cfg

TOP_K, THRESH = 8, 50.0
OL_TOP_K, OL_CONF = 4, 0.5  # openlane_config's; O = 72, n_lengths = 1


def score_key(scores: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving map of a float score to 32 unsigned
    bits (in int64): -0.0 as +0.0, NaN below every other score."""
    s = torch.where(scores == 0, torch.zeros_like(scores), scores)
    bits = s.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(bits >= 0x80000000, ~bits & 0xFFFFFFFF,
                      bits | 0x80000000)
    return torch.where(torch.isnan(scores), torch.zeros_like(key), key)


def pick_model(proposals, scores, valid, thresh, n_offsets, top_k):
    """The kernel's algorithm on one stream: repeatedly pick the candidate
    (valid, not suppressed, not kept) of the highest key, ties to the
    lowest index, and drop every candidate it suppresses; the distance is
    summed over all points in ascending order, out-of-window ones adding
    +0.0. Strip windows as the kernel computes them, unsorted."""
    a = proposals.shape[0]
    n_strips = n_offsets - 1
    start = torch.trunc(proposals[:, 2] * n_strips + 0.5).to(torch.int32)
    length = proposals[:, 4]
    end = torch.trunc(start.to(torch.float32) + length - 0.5
                      - (length - 1.0 < 0).to(torch.float32)).to(torch.int32)
    end = torch.clamp(end, max=n_offsets - 1)
    xs = proposals[:, 5:5 + n_offsets]
    key = score_key(scores)
    cand = valid.clone()
    picks = []
    points = torch.arange(n_offsets, dtype=torch.int32)
    for _ in range(top_k):
        if not cand.any():
            break
        best = torch.where(cand, key, -1).max()
        i = int(torch.argmax((cand & (key == best)).to(torch.int8)))
        picks.append(i)
        ps, pe = torch.maximum(start[i], start), torch.minimum(end[i], end)
        dist = torch.zeros(a)
        for q in range(n_offsets):
            inside = (points[q] >= ps) & (points[q] <= pe)
            dist = dist + torch.where(inside, (xs[i, q] - xs[:, q]).abs(),
                                      0.0)
        drop = (pe >= ps) & (dist < thresh * (pe - ps + 1).to(torch.float32))
        drop[i] = True
        cand &= ~drop
    keep_idx = torch.full((top_k,), -1, dtype=torch.long)
    keep_idx[:len(picks)] = torch.tensor(picks, dtype=torch.long)
    keep_mask = torch.zeros(a, dtype=torch.bool)
    keep_mask[picks] = True
    return keep_idx, torch.tensor(len(picks)), keep_mask


# name: (kind, seed, A, O, top_k, lane layout's n_lengths)
CASES = {f"seeded{seed}": ("seeded", seed, 240, 36, TOP_K, 2)
         for seed in range(3)}
CASES.update({kind: (kind, 3, 240, 36, TOP_K, 2)
              for kind in chip_smoke.NMS_KINDS[1:]})
CASES["runtime_shape"] = ("seeded", 8, 32, 12, TOP_K, 2)
CASES.update({f"ol_{kind}": (kind, 11, 240, 72, OL_TOP_K, 1)
              for kind in chip_smoke.NMS_KINDS})
# the prior-propagation head's rows: 240 anchors and K = 4 slots, empty
# slots dead rows (a partial last warp on the card)
CASES["propagate_rows"] = ("dead_rows", 12, 244, 72, OL_TOP_K, 1)


def case(name):
    """(proposals [A, 5 + O], scores [A], valid [A], n_offsets, top_k): a
    stream of ``chip_smoke.nms_stream``, the card's checks' own (its valid
    flags at confidence 0.3, its -0.0 and NaN rows valid), as proposal
    rows from its lane layout."""
    kind, seed, a, n_off, top_k, n_len = CASES[name]
    routed, scores, valid = chip_smoke.nms_stream(kind, seed, a, n_off, 0.3,
                                                  n_len)
    props = tnms.nms_proposals_from_predictions(
        torch.from_numpy(routed),
        TorchLaneSpec(n_offsets=n_off, n_lengths=n_len), 768)
    return props.numpy(), scores, valid, n_off, top_k


@pytest.mark.parametrize("oracle", ["plain", "jax", "pallas_interpret"])
@pytest.mark.parametrize("name", list(CASES))
def test_pick_model_bit_equal(name, oracle):
    p, s, v, n_off, top_k = case(name)
    got = pick_model(torch.from_numpy(p), torch.from_numpy(s),
                     torch.from_numpy(v), THRESH, n_off, top_k)
    if oracle == "plain":
        ref = tnms.lane_nms_plain(
            torch.from_numpy(p)[None], torch.from_numpy(s)[None],
            torch.from_numpy(v)[None], THRESH, n_off, top_k)
        ref = tuple(r[0] for r in ref)
    else:
        fn = lane_nms if oracle == "jax" else lambda *a, **k: \
            lane_nms_pallas(*a, **k, interpret=True)
        ref = fn(jnp.asarray(p), jnp.asarray(s), jnp.asarray(v), THRESH,
                 n_offsets=n_off, top_k=top_k)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    kind = CASES[name][0]
    if kind == "neg_zero":
        assert got[0][:2].tolist() == [3, 11] and int(got[1]) == 2
    if kind == "nan_score":
        assert got[0][:4].tolist() == [9, 31, 2, 30][:top_k]


# layout: (O, top_k, confidence, n_lengths)
LAYOUTS = {"vil": (36, TOP_K, 0.6, 2), "ol": (72, OL_TOP_K, OL_CONF, 1)}


def seeded_routed(seed, layout="vil"):
    """Routed predictions [4, 240, 5 + n_lengths + O] of a layout: three
    seeded streams of ``chip_smoke.nms_stream`` (cls logits standard
    normal, so about 40% of the rows score 0.6 or more) and one standard
    normal throughout (negative starts and lengths)."""
    n_off, _, _, n_len = LAYOUTS[layout]
    streams = [chip_smoke.nms_stream("seeded", 4 * seed + i, 240, n_off,
                                     n_lengths=n_len)[0] for i in range(3)]
    streams.append(np.random.default_rng(seed).normal(
        size=streams[0].shape).astype(np.float32))
    return np.stack(streams)


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_keeps_plain_matches_jax_chain(seed):
    """``nms_keeps_plain`` (torch softmax) against the JAX chain of
    ``PHNet._nms_keeps``: kept, keep_idx and num_kept bit-equal."""
    check_keeps_against_jax_chain(seed, "vil")


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_keeps_plain_matches_jax_chain_at_openlane_shape(seed):
    """As above in OL's lane layout, 72 offsets, top_k 4, conf 0.5."""
    check_keeps_against_jax_chain(seed, "ol")


def check_keeps_against_jax_chain(seed, layout):
    n_off, top_k, conf, n_len = LAYOUTS[layout]
    routed = seeded_routed(seed, layout)
    img_w = 768
    jr = jnp.asarray(routed)
    scores = jax.nn.softmax(jr[..., :2], axis=-1)[..., 1]
    props = nms_proposals_from_predictions(
        jr, JaxLaneSpec(n_offsets=n_off, n_lengths=n_len), img_w)
    keep_idx, num_kept, _ = jax.vmap(lambda pr, sc, va: lane_nms(
        pr, sc, va, THRESH, n_offsets=n_off, top_k=top_k))(
            props, scores, scores >= conf)
    kept = jnp.take_along_axis(
        jr, jnp.clip(keep_idx, 0, routed.shape[1] - 1)[..., None], axis=1)

    tr = torch.from_numpy(routed)
    got = tnms.nms_keeps_plain(
        tr, torch.softmax(tr[..., :2], dim=-1)[..., 1],
        TorchLaneSpec(n_offsets=n_off, n_lengths=n_len), img_w, conf, THRESH,
        top_k)
    for g, r in zip(got[:3], (kept, keep_idx, num_kept)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(num_kept.sum()) > 0 and int((num_kept == top_k).sum()) > 0


def test_phnet_nms_keeps_on_cpu_launches_no_kernel():
    """On CPU tensors ``PHNet.nms_keeps`` runs the plain version: the
    kernel's counter does not move, and the keeps equal
    ``nms_keeps_plain``'s on the model's configuration."""
    cfg = torch_cfg()
    model = PHNet(cfg, device="cpu")
    spec = cfg.lane
    rng = np.random.default_rng(7)
    routed = torch.from_numpy(rng.normal(
        size=(3, cfg.head.num_priors, spec.dim)).astype(np.float32))
    routed[..., spec.col_start_y] = routed[..., spec.col_start_y].abs() / 4
    launches = tnms.lane_nms.launches
    got = model.nms_keeps(routed)
    assert tnms.lane_nms.launches == launches
    ref = tnms.nms_keeps_plain(
        routed, torch.softmax(routed[..., :2], dim=-1)[..., 1], spec,
        cfg.img_w, cfg.test.conf_threshold, cfg.test.nms_thres,
        cfg.test.nms_topk)
    for g, r in zip(got, ref[:3]):
        assert torch.equal(g, r)
    assert int(got[2].sum()) > 0
