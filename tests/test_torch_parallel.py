"""``phnet_torch.parallel``: the mesh against the JAX package's
``make_mesh`` (its model axis too), and the process group's helpers and
train-mode BatchNorm over two gloo ranks on the CPU
(``tests/_torch_dist_worker.py``, case ``bn``).

BatchNorm under a group of two ranks takes the statistics of the global
batch (``SyncBatchNorm``'s semantics, GSPMD's one step over the global
batch): each rank's output, statistics and input gradient are its rows
of JAX's ``bn_train_normalize`` on the global batch, and the sum of the
ranks' parameter gradients is JAX's, within 1e-5 of the largest entry
(the sums run in another order: float64 sums of the ranks' float32
sums); the port's one-process call on the global batch within the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from phnet_torch.ops.batchnorm import bn_train_normalize
from phnet_torch.parallel import make_mesh
from phnet_torch.parallel import multihost
from phnet_tpu.ops.batchnorm import bn_train_normalize as jax_normalize
from phnet_tpu.parallel import make_mesh as jax_make_mesh


@pytest.mark.parametrize("n_devices", [None, 4, 1])
def test_mesh_layout_matches_jax(n_devices):
    """Over the suite's 8 CPU devices: the same (data, model) shape and
    axis names, the devices in order down the data axis."""
    ref = jax_make_mesh(n_devices)
    names = [f"cpu:{i}" for i in range(8)]
    got = make_mesh(n_devices, devices=names)
    assert got.axis_names == tuple(ref.axis_names) == ("data", "model")
    assert got.shape == dict(ref.shape)
    assert got.devices.shape == ref.devices.shape
    assert [str(d) for d in got.data_devices()] == [
        f"cpu:{d.id}" for d in ref.devices[:, 0]]


@pytest.mark.parametrize("model_parallel", [2, 4])
def test_model_axis_is_not_ported(model_parallel):
    """The model axis, once refused, is ported: ``make_mesh(8,
    model_parallel=m)`` lays the devices out as JAX's, ``reshape(8 // m,
    m)``, data down the first column."""
    ref = jax_make_mesh(8, model_parallel=model_parallel)
    got = make_mesh(8, model_parallel=model_parallel,
                    devices=[f"cpu:{i}" for i in range(8)])
    assert got.shape == dict(ref.shape) == {"data": 8 // model_parallel,
                                            "model": model_parallel}
    assert [[str(d) for d in row] for row in got.devices] == [
        [f"cpu:{d.id}" for d in row] for row in ref.devices]
    assert [str(d) for d in got.data_devices()] == [
        f"cpu:{d.id}" for d in ref.devices[:, 0]]
    with pytest.raises(ValueError, match="do not split"):
        make_mesh(6, model_parallel=4, devices=["cpu"] * 6)


def test_one_process_helpers_without_a_group():
    assert not multihost.in_group()
    assert (multihost.world_size(), multihost.rank()) == (1, 0)
    assert not multihost.is_multihost()
    buf = torch.arange(4.0)
    assert multihost.all_reduce_mean(buf) is buf
    assert torch.equal(buf, torch.arange(4.0))
    multihost.barrier()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
            multihost.initialize("127.0.0.1:1", 1, 0)


@pytest.fixture(scope="module")
def bn_ranks(tmp_path_factory):
    return worker.run_ranks("bn", 2, str(tmp_path_factory.mktemp("bn")
                                         / "out"))


def jax_reference():
    p = worker.bn_problem()
    nhwc = [np.ascontiguousarray(p[k].transpose(0, 2, 3, 1))
            for k in ("x", "g")]
    y, vjp = jax.vjp(jax_normalize, jnp.asarray(nhwc[0]),
                     jnp.asarray(p["scale"]), jnp.asarray(p["bias"]))
    dx, ds, db = vjp(jnp.asarray(nhwc[1]))
    back = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    x = nhwc[0].reshape(-1, nhwc[0].shape[-1])
    return dict(y=back(y), dx=back(dx), dscale=np.asarray(ds),
                dbias=np.asarray(db), mean=x.mean(0, dtype=np.float64),
                var=x.var(0, dtype=np.float64))


def one_process():
    out = worker.one_process("bn")
    return {k: v.numpy() for k, v in out.items() if torch.is_tensor(v)}


def close(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("ref", ["jax", "port"])
def test_batchnorm_over_two_ranks_is_the_global_batch(bn_ranks, ref):
    want = jax_reference() if ref == "jax" else one_process()
    got = [{k: v.numpy() for k, v in r.items() if torch.is_tensor(v)}
           for r in bn_ranks]
    for key in ("y", "dx"):
        close(np.concatenate([g[key] for g in got]), want[key])
    for key in ("dscale", "dbias"):
        close(got[0][key] + got[1][key], want[key])
    for key in ("mean", "var"):
        assert np.array_equal(got[0][key], got[1][key])
        close(got[0][key], want[key])


def test_batchnorm_one_rank_is_the_one_process_arithmetic():
    """Without a group the statistics and the backward are the
    one-process formulas to the bit (``bn_case`` on the whole batch
    against a direct call)."""
    p = worker.bn_problem()
    x = torch.from_numpy(p["x"]).requires_grad_(True)
    y, mean, var = bn_train_normalize(x, torch.from_numpy(p["scale"]),
                                      torch.from_numpy(p["bias"]))
    y.backward(torch.from_numpy(p["g"]))
    out = one_process()
    assert np.array_equal(out["y"], y.detach().numpy())
    assert np.array_equal(out["dx"], x.grad.numpy())
    assert np.array_equal(out["mean"], mean.numpy())


def test_group_helpers_over_two_ranks(bn_ranks):
    """Ranks that start apart fail the bit check on every rank; after the
    broadcast they hold rank 0's bits; the mean of a buffer over ranks."""
    for r in bn_ranks:
        assert r["apart_raised"]
        assert torch.equal(r["running_mean"], torch.zeros(3))
        assert torch.equal(r["mean_of_ranks"], torch.arange(3.0) + 0.5)


def test_worker_imports_the_port_only():
    """The ranks' script imports ``phnet_torch`` and no JAX: the ranks
    run the port alone, as on a card."""
    import ast
    from pathlib import Path

    path = Path(worker.__file__)
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "phnet_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "optax", "phnet_tpu"}
