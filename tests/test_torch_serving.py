"""StreamingServer of the port against the JAX server on the small
configuration: two streams, a skipped tick, detach and re-attach; and the
``quantize="w8"`` server."""

import dataclasses

import numpy as np
import pytest
import torch

import phnet_torch.config as tcfg
import phnet_tpu.config as jcfg
from phnet_torch.convert import convert
from phnet_torch.serving import StreamingServer as TorchServer
from phnet_tpu.serving import StreamingServer as JaxServer

import torch_parity as tp

WINDOW = 4


@pytest.fixture(scope="module")
def servers():
    variables = tp.init_variables(tp.jax_cfg(), seed=1)
    js = JaxServer(jcfg.Config(model=tp.jax_cfg()), tp.jax_tree(variables),
                   max_streams=2, memory_window=WINDOW)
    ts = TorchServer(tcfg.Config(model=tp.torch_cfg()), convert(variables),
                     max_streams=2, memory_window=WINDOW, device="cpu")
    return js, ts


def schedule():
    """(tick, {stream: frame seed}) with stream 1 skipping tick 2 and
    re-attached (fresh memory) before tick 4."""
    return [{0: 10, 1: 20}, {0: 11, 1: 21}, {0: 12}, {0: 13, 1: 23},
            "reattach", {0: 14, 1: 30}, {0: 15, 1: 31}]


def test_served_outputs_match_jax(servers):
    js, ts = servers
    for server in (js, ts):
        assert (server.attach(ori_img_h=720, cut_height=252),
                server.attach()) == (0, 1)
    n_lanes = 0
    for tick in schedule():
        if tick == "reattach":
            for server in (js, ts):
                server.detach(1)
                assert server.attach() == 1
            np.testing.assert_array_equal(np.asarray(js.memory.mask),
                                          tp.to_np(ts.memory.mask))
            continue
        frames = {sid: tp.seeded_frames(seed, (64, 128, 3))
                  for sid, seed in tick.items()}
        jk, jvalid, jsids = js.step_async(frames)
        tk, tvalid, tsids = ts.step_async(frames)
        assert jsids == tsids
        assert tuple(tk.shape) == (2, 4, 19)  # [streams, top_k, dim]
        np.testing.assert_array_equal(tp.to_np(tvalid), np.asarray(jvalid))
        np.testing.assert_allclose(tp.to_np(tk), np.asarray(jk), rtol=0,
                                   atol=1e-4)
        np.testing.assert_array_equal(tp.to_np(ts.memory.mask),
                                      np.asarray(js.memory.mask))
        jl, tl = js.decode(jk, jvalid, jsids), ts.decode(tk, tvalid, tsids)
        assert jl.keys() == tl.keys()
        for sid in jl:
            assert len(jl[sid]) == len(tl[sid])
            for a, b in zip(jl[sid], tl[sid]):
                np.testing.assert_allclose(b.points, a.points, rtol=0,
                                           atol=1e-5)
            n_lanes += len(tl[sid])
    assert n_lanes > 0
    assert ts.memory.t == int(js.memory.t) == 6
    st = ts.stats()
    assert st["ticks"] == 6 and st["frames"] == 11
    assert st["frames_per_stream"] == [6, 2]
    assert st["dispatch_ms_p99"] >= st["dispatch_ms_p50"] > 0


def test_update_variables_rebuilds_combined_weights(servers):
    _, ts = servers
    variables = tp.init_variables(tp.jax_cfg(), seed=2)
    before = ts._dyn[0]["gen1"][0].clone()
    ts.update_variables(convert(variables))
    assert not np.allclose(tp.to_np(ts._dyn[0]["gen1"][0]),
                           tp.to_np(before))


def test_w8_server_matches_jax():
    """``quantize="w8"`` servers, two streams, a skipped tick: valid slots
    equal, kept rows within 1e-2 and decoded lane counts equal (rounding
    flips at the bf16 casts, see ``test_torch_quant.py``)."""
    variables = tp.init_variables(tp.jax_cfg(), seed=1)
    js = JaxServer(jcfg.Config(model=dataclasses.replace(
        tp.jax_cfg(), quantize="w8")), tp.jax_tree(variables), max_streams=2,
        memory_window=WINDOW)
    ts = TorchServer(tcfg.Config(model=dataclasses.replace(
        tp.torch_cfg(), quantize="w8")), convert(variables), max_streams=2,
        memory_window=WINDOW, device="cpu")
    assert ts._dyn[0]["gen2"]["wq1"].dtype == torch.int8
    for server in (js, ts):
        server.attach(ori_img_h=720, cut_height=252)
        server.attach()
    n_lanes = 0
    for tick in ({0: 10, 1: 20}, {0: 11}, {0: 12, 1: 22}):
        frames = {sid: tp.seeded_frames(seed, (64, 128, 3))
                  for sid, seed in tick.items()}
        jk, jvalid, jsids = js.step_async(frames)
        tk, tvalid, tsids = ts.step_async(frames)
        np.testing.assert_array_equal(tp.to_np(tvalid), np.asarray(jvalid))
        np.testing.assert_allclose(tp.to_np(tk), np.asarray(jk), rtol=0,
                                   atol=1e-2)
        np.testing.assert_array_equal(tp.to_np(ts.memory.mask),
                                      np.asarray(js.memory.mask))
        jl, tl = js.decode(jk, jvalid, jsids), ts.decode(tk, tvalid, tsids)
        assert {s: len(v) for s, v in jl.items()} == {
            s: len(v) for s, v in tl.items()}
        n_lanes += sum(len(v) for v in tl.values())
    assert n_lanes > 0
    before = ts._dyn[0]["gen1"]["wq"].clone()
    ts.update_variables(convert(tp.init_variables(tp.jax_cfg(), seed=2)))
    assert ts._dyn[0]["gen1"]["wq"].dtype == torch.int8
    assert not torch.equal(ts._dyn[0]["gen1"]["wq"], before)  # re-quantized
