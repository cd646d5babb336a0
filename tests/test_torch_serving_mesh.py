"""The server's streams split over a mesh's ``data`` axis
(``StreamingServer(mesh=...)``) on the CPU, ``make_mesh(devices=["cpu",
"cpu"])``: two replicas of two streams each, against the one-device
server of the port and the JAX server (``tests/test_torch_serving.py``'s
oracle) over a schedule of four streams with skipped ticks on both
replicas, a detach and re-attach on the second and a weight swap.

Per tick: the valid slots and the memory mask equal, the kept rows within
1e-4 of the JAX server's (that test's bound) and of the one-device
server's, the decoded lanes equal in count. The router chain's mode
follows the global ``max_streams``; the w8 model splits too (held to the
one-device w8 server at ``test_w8_server_matches_jax``'s 1e-2); what a
mesh cannot take raises. A mesh with a ``model`` axis
(``make_mesh(devices=["cpu"] * 4, model_parallel=2)``) replicates the
weights over each data row, as the JAX server's does: its ticks equal the
data-only mesh's bit for bit and match the JAX server on
``make_mesh(4, model_parallel=2)``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import phnet_torch.config as tcfg
import phnet_tpu.config as jcfg
from phnet_torch.convert import convert
from phnet_torch.models.phnet import PHNet
from phnet_torch.parallel import make_mesh
from phnet_torch.serving import StreamingServer as TorchServer
from phnet_tpu.parallel import make_mesh as jax_make_mesh
from phnet_tpu.serving import StreamingServer as JaxServer

import torch_parity as tp

WINDOW = 4
STREAMS = 4
SCHEDULE = [{0: 10, 1: 20, 2: 30, 3: 40}, {0: 11, 2: 31, 3: 41},
            {0: 12, 1: 22, 3: 42}, "reattach", {0: 13, 1: 23, 2: 33, 3: 50},
            "swap", {0: 14, 1: 24, 2: 34, 3: 51}, {1: 25, 3: 52},
            {0: 16, 1: 26, 2: 36, 3: 53}]


def mesh_server(cfg, variables, model_parallel=1, **kw):
    return TorchServer(cfg, convert(variables), max_streams=STREAMS,
                       memory_window=WINDOW, mesh=make_mesh(
                           devices=["cpu"] * (2 * model_parallel),
                           model_parallel=model_parallel), **kw)


def drive(servers, swap, n_ticks_want=7):
    """Run :data:`SCHEDULE` through ``servers`` (JAX first, if any, then
    the port's); yields each tick's (kept, valid, decoded lanes) per
    server."""
    for s in servers:
        assert [s.attach(ori_img_h=720, cut_height=252) for _ in
                range(STREAMS)] == list(range(STREAMS))
    ticks = 0
    for tick in SCHEDULE:
        if tick == "reattach":
            for s in servers:
                s.detach(3)
                assert s.attach() == 3
            continue
        if tick == "swap":
            for s in servers:
                s.update_variables(tp.jax_tree(swap)
                                   if isinstance(s, JaxServer)
                                   else convert(swap))
            continue
        frames = {sid: tp.seeded_frames(seed, (64, 128, 3))
                  for sid, seed in tick.items()}
        out = []
        for s in servers:
            kept, valid, sids = s.step_async(frames)
            assert sids == list(tick)
            gather = (np.asarray if isinstance(s, JaxServer)
                      else TorchServer.gather)
            out.append((gather(kept), gather(valid),
                        s.decode(kept, valid, sids),
                        tp.to_np(s.memory.mask)))
        ticks += 1
        yield out
    assert ticks == n_ticks_want


@pytest.fixture(scope="module")
def weights():
    """The served weights and the swap's (JAX trees, numpy)."""
    return (tp.init_variables(tp.jax_cfg(), seed=1),
            tp.init_variables(tp.jax_cfg(), seed=2))


@pytest.fixture(scope="module")
def port_weights():
    """A random draw of the port's small model (no JAX oracle needed)."""
    return PHNet(tp.torch_cfg(), device="cpu").state_dict()


def test_split_server_matches_one_device_and_jax(weights):
    variables, swap = weights
    js = JaxServer(jcfg.Config(model=tp.jax_cfg()), tp.jax_tree(variables),
                   max_streams=STREAMS, memory_window=WINDOW)
    one = TorchServer(tcfg.Config(model=tp.torch_cfg()), convert(variables),
                      max_streams=STREAMS, memory_window=WINDOW,
                      device="cpu")
    split = mesh_server(tcfg.Config(model=tp.torch_cfg()), variables)
    assert [r.device for r in split.replicas] == [torch.device("cpu")] * 2
    n_lanes = 0
    for (jk, jv, jl, jm), (ok, ov, ol, om), (sk, sv, sl, sm) in drive(
            [js, one, split], swap):
        assert sk.shape == (STREAMS, 4, 19)
        np.testing.assert_array_equal(sv, jv)
        np.testing.assert_array_equal(sv, ov)
        np.testing.assert_allclose(sk, jk, rtol=0, atol=1e-4)
        np.testing.assert_allclose(sk, ok, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(sm, jm)
        np.testing.assert_array_equal(sm, om)
        assert {s: len(v) for s, v in sl.items()} == {
            s: len(v) for s, v in jl.items()}
        n_lanes += sum(len(v) for v in sl.values())
    assert n_lanes > 0
    assert split.memory.t == one.memory.t == int(js.memory.t) == 7
    np.testing.assert_allclose(tp.to_np(split.memory.values),
                               tp.to_np(one.memory.values), rtol=0,
                               atol=1e-4)
    st = split.stats()
    assert st["ticks"] == 7 and st["frames_per_stream"] == [6, 6, 5, 4]


def test_model_axis_server_is_the_data_only_server(weights):
    """Two data rows of two devices each: one replica a row, bit-equal to
    the data-only mesh's two replicas, and within the split server's
    bounds of the JAX server on a (2, 2) mesh on the tick's streams (a
    skipped stream's kept and valid rows come from its stale frame buffer,
    which
    the JAX package's mesh path fills otherwise than its one-device path:
    its own two servers differ there)."""
    variables, swap = weights
    js = JaxServer(jcfg.Config(model=tp.jax_cfg()), tp.jax_tree(variables),
                   max_streams=STREAMS, memory_window=WINDOW,
                   mesh=jax_make_mesh(4, model_parallel=2))
    cfg = tcfg.Config(model=tp.torch_cfg())
    data = mesh_server(cfg, variables)
    model = mesh_server(cfg, variables, model_parallel=2)
    assert model.mesh.shape == {"data": 2, "model": 2}
    assert len(model.replicas) == 2
    ticks = [t for t in SCHEDULE if isinstance(t, dict)]
    for tick, ((jk, jv, jl, jm), (dk, dv, dl, dm), (mk, mv, ml, mm)) in zip(
            ticks, drive([js, data, model], swap)):
        for a, b in ((mk, dk), (mv, dv), (mm, dm)):
            assert np.array_equal(a, b)
        assert {s: len(v) for s, v in ml.items()} == {
            s: len(v) for s, v in dl.items()}
        sids = sorted(tick)
        np.testing.assert_array_equal(mv[sids], jv[sids])
        np.testing.assert_allclose(mk[sids], jk[sids], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(mm, jm)
        assert {s: len(v) for s, v in ml.items()} == {
            s: len(v) for s, v in jl.items()}
    assert torch.equal(model.memory.values, data.memory.values)
    np.testing.assert_allclose(tp.to_np(model.memory.values),
                               tp.to_np(js.memory.values), rtol=0, atol=1e-4)
    assert model.memory.t == int(js.memory.t) == 7


def test_w8_split_server_matches_one_device(weights):
    variables, swap = weights
    cfg = tcfg.Config(model=dataclasses.replace(tp.torch_cfg(),
                                                quantize="w8"))
    one = TorchServer(cfg, convert(variables), max_streams=STREAMS,
                      memory_window=WINDOW, device="cpu")
    split = mesh_server(cfg, variables)
    for r in split.replicas:
        assert r.dyn[0]["gen2"]["wq1"].dtype == torch.int8
    for (ok, ov, ol, om), (sk, sv, sl, sm) in drive([one, split], swap):
        np.testing.assert_array_equal(sv, ov)
        np.testing.assert_allclose(sk, ok, rtol=0, atol=1e-2)
        np.testing.assert_array_equal(sm, om)
        assert {s: len(v) for s, v in sl.items()} == {
            s: len(v) for s, v in ol.items()}


@pytest.mark.parametrize("streams,devices,bf16", [
    (10, 2, True), (8, 4, False), (4, 2, False)])
def test_chain_mode_follows_the_global_streams(port_weights, streams,
                                              devices, bf16):
    """Above 8 streams in all the chain runs in bf16 on every replica,
    whatever each replica's share."""
    server = TorchServer(tcfg.Config(model=tp.torch_cfg()), port_weights,
                         max_streams=streams,
                         mesh=make_mesh(devices=["cpu"] * devices))
    assert server.cfg.model.head.router_chain_bf16 is bf16
    assert len(server.replicas) == devices
    for r in server.replicas:
        assert all(x.chain_bf16 is bf16 for x in r.model.head.routers)


def test_what_a_mesh_cannot_take_raises(port_weights):
    cfg = tcfg.Config(model=tp.torch_cfg())
    sd = port_weights
    with pytest.raises(ValueError, match="divisible by the mesh data axis"):
        TorchServer(cfg, sd, max_streams=3,
                    mesh=make_mesh(devices=["cpu", "cpu"]))
    with pytest.raises(ValueError, match="a device or a mesh"):
        TorchServer(cfg, sd, max_streams=2, device="cpu",
                    mesh=make_mesh(devices=["cpu", "cpu"]))
