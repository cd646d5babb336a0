"""The mesh's ``model`` axis in the port (``phnet_torch.parallel``): the
placement rule against the JAX package's, the sharded layers over two
gloo ranks on the CPU, and the trainer's step over a ``(data, model)``
process group against JAX's ``shard_params`` step and the port's one
process.

* ``shard_params`` decides, for every leaf of every preset and backbone
  at full width (``jax.eval_shape``, no compute) and of a synthetic tree
  that reaches the rule's first-dimension and whole branches, the same
  flax dimension as ``phnet_tpu/parallel/mesh.py::_param_spec``,
  translated through ``phnet_torch.convert``'s layouts, at model 2 and 4.
* The sharded Linear, Conv1d and Conv2d (``tests/_torch_dist_worker.py``,
  case ``tp_layers``), split on the output and on the first dimension,
  hold the whole layer's output and gradients within 1e-5 of their
  largest entry (the output split gives the same dot products; the
  first-dimension split sums partial products in another order, and the
  input gradient of the output split sums the ranks' shares).
* The trainer at the JAX dry run's geometry and ``min_size=1024``
  (``TP_MIN_SIZE`` set on the port, ``min_size=`` passed to JAX), case
  ``tp_train``:

  - data 2 x model 2 (4 ranks), decoder dropout 0, from weights drawn
    for the JAX tree: the first step against JAX's loss and gradient on a
    ``make_mesh(4, model_parallel=2)`` mesh of the suite's CPU devices with
    ``shard_params(..., min_size=1024)`` (``test_torch_train.py``'s
    float32 bounds: the loss within 2e-5 relative, the gradient norm within
    1e-4 relative, each gradient leaf within ``leaf_tolerance`` of its
    largest entry plus 1e-5, BatchNorm's running statistics within 1e-5),
    and both steps (the second resumed from the first's checkpoint)
    against the port's one-process step on the global batch
    (``test_torch_dist_train.py``'s ``step_errors``: the same bounds);
  - data 1 x model 2, dropout 0.1, resumed from a checkpoint that one
    process wrote (model 1 -> 2): its step against the one-process step at
    those bounds; its checkpoint (model 2) restored by one process equals
    the ranks' gathered state (model 2 -> 1) and has a model 1 file's
    keys, shapes and dtypes;
  - every rank holds the same bits in its whole parameters and buffers,
    the ranks of a data group in their blocks; the model group's blocks
    join into the recorded whole tensors.

Measured here: the ranks' steps equal the one-process steps' losses to
the bit and every gradient leaf well inside its bound; against JAX the
same bounds as the one-process port.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

import _torch_dist_worker as worker
import phnet_torch.config as tcfgmod
import phnet_tpu.config as jcfgmod
import torch_parity as tp
from phnet_torch.convert import convert, torch_key
from phnet_torch.models import PHNet as TorchPHNet
from phnet_torch.parallel import make_mesh, shard_params
from phnet_torch.train.checkpoint import CheckpointManager
from phnet_torch.train.state import create_train_state
from phnet_tpu.losses import LaneCriterion as JaxCriterion
from phnet_tpu.models import PHNet as JaxPHNet
from phnet_tpu.parallel import make_mesh as jax_make_mesh
from phnet_tpu.parallel.mesh import (TP_MIN_SIZE, _param_spec,
                                     batch_sharding, replicate_sharding)
from phnet_tpu.parallel.mesh import shard_params as jax_shard_params
from test_torch_dist_train import one_ulp, step_errors
from torch_train_parity import leaf_tolerance

ULP_COPIES = 4

# -- the placement rule ---------------------------------------------------------

BACKBONES = {"resnet18": {}, "revcol": dict(kind="revcol"),
             "resnet50": dict(depth=50), "groupnorm": dict(norm="group")}
PRESETS = ["vil100_config", "openlane_config", "openlane_multiscale_config",
           "openlane_propagate_config"] + [
               f"vil100_config/{b}" for b in BACKBONES if b != "resnet18"]


def preset_model(cfgmod, preset):
    name, _, backbone = preset.partition("/")
    m = getattr(cfgmod, name)().model
    if backbone:
        neck = m.neck
        if backbone == "resnet50":  # a Bottleneck stage's output: 4x
            neck = dataclasses.replace(neck, in_channels=(512, 1024, 2048))
        m = dataclasses.replace(m, backbone=cfgmod.BackboneConfig(
            **BACKBONES[backbone]), neck=neck)
    return m


@functools.lru_cache(maxsize=None)
def preset_trees(preset):
    """(the JAX ``variables`` as shapes, the port's model on ``meta``)."""
    return (tp.variable_shapes(preset_model(jcfgmod, preset)),
            TorchPHNet(preset_model(tcfgmod, preset), device="meta"))


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


# the torch dimension of a flax kernel's last and first dimension, by
# ``torch_key``'s layout change (a leaf kept in the flax layout: the same)
TORCH_DIM = {"linear": {"last": 0, "first": 1},
             "conv": {"last": 0, "first": 2},
             "conv1d": {"last": 0, "first": 2}}


def jax_decisions(shapes, m, min_size):
    """{port key: the torch dimension of JAX's split (None: whole)} over
    the ``params`` leaves."""
    out = {}
    for path, leaf in leaves(shapes["params"], ("params",)):
        spec = tuple(_param_spec("/".join(path), leaf, m, min_size))
        key, change = torch_key(path, len(leaf.shape))
        dim = spec.index("model") if "model" in spec else None
        if dim is not None and change:
            dim = TORCH_DIM[change]["last" if dim == leaf.ndim - 1
                                    else "first"]
        out[key] = dim
    return out


def mesh_of(m):
    return make_mesh(devices=["cpu"] * 8, model_parallel=m)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("preset", PRESETS)
def test_shard_params_matches_the_jax_rule(preset, m):
    shapes, model = preset_trees(preset)
    want = jax_decisions(shapes, m, TP_MIN_SIZE)
    got = shard_params(model, mesh_of(m))
    assert got == want
    assert any(d is not None for d in got.values())


def test_vil100_shards_its_fat_kernels_on_the_output_dimension():
    """31 kernels, 82,288,640 of the 83,486,697 parameters, all on the
    output dimension (torch dim 0) at model = 2."""
    _, model = preset_trees("vil100_config")
    got = shard_params(model, mesh_of(2))
    params = dict(model.named_parameters())
    split = {n: d for n, d in got.items() if d is not None}
    assert len(split) == 31 and set(split.values()) == {0}
    assert sum(params[n].numel() for n in split) == 82_288_640
    assert sum(p.numel() for p in params.values()) == 83_486_697


class Synthetic(nn.Module):
    """Leaves that reach every branch of the rule at ``min_size`` 64 (the
    flax shape's last dimension odd where the rule falls back)."""

    def __init__(self):
        super().__init__()
        self.lin_out = nn.Linear(64, 32)      # flax [64, 32]: last
        self.lin_first = nn.Linear(64, 33)    # [64, 33]: first
        self.lin_whole = nn.Linear(33, 35)    # [33, 35]: whole
        self.conv_first = nn.Conv2d(3, 33, (4, 3))  # [4, 3, 3, 33]: first
        self.conv_out = nn.Conv2d(3, 8, 3)    # [3, 3, 3, 8]: last
        self.conv1d_first = nn.Conv1d(5, 33, 4)  # [4, 5, 33]: first
        self.packed = nn.Parameter(torch.zeros(6, 35))  # flax layout: first
        self.small = nn.Linear(2, 4)          # < min_size: whole


SYNTHETIC_FLAX = {"params": {
    "lin_out": {"kernel": (64, 32), "bias": (32,)},
    "lin_first": {"kernel": (64, 33), "bias": (33,)},
    "lin_whole": {"kernel": (33, 35), "bias": (35,)},
    "conv_first": {"kernel": (4, 3, 3, 33), "bias": (33,)},
    "conv_out": {"kernel": (3, 3, 3, 8), "bias": (8,)},
    "conv1d_first": {"kernel": (4, 5, 33), "bias": (33,)},
    "packed": (6, 35),
    "small": {"kernel": (2, 4), "bias": (4,)}}}


@pytest.mark.parametrize("m", [2, 4])
def test_shard_params_reaches_every_branch(m):
    shapes = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s, jnp.float32), SYNTHETIC_FLAX,
        is_leaf=lambda x: isinstance(x, tuple))
    want = {k.removeprefix("params."): d  # a top-level module's keys
            for k, d in jax_decisions(shapes, m, 64).items()}
    got = shard_params(Synthetic(), mesh_of(m), min_size=64)
    assert got == want
    kinds = {k: d for k, d in got.items() if k.endswith(("weight", "packed"))}
    assert kinds["lin_out.weight"] == 0 and kinds["conv_out.weight"] == 0
    assert kinds["lin_first.weight"] == 1
    assert kinds["conv_first.weight"] == kinds["conv1d_first.weight"] == 2
    assert kinds["lin_whole.weight"] is None and kinds["small.weight"] is None
    assert kinds["packed"] == (0 if m == 2 else None)


# -- the sharded layers -----------------------------------------------------------

@pytest.fixture(scope="module")
def layer_ranks(tmp_path_factory):
    return worker.run_ranks("tp_layers", 2, str(
        tmp_path_factory.mktemp("tp_layers") / "out"))


def close(got, want, rel=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=rel * float(want.abs().max()))


@pytest.mark.parametrize("name", list(worker.TP_LAYERS))
def test_sharded_layer_matches_the_whole_layer(layer_ranks, name):
    layer, x, g = worker.tp_layer(name)
    x.requires_grad_(True)
    y = layer(x)
    y.backward(g)
    dim = 0 if name.endswith("out") else (1 if name.startswith("linear")
                                          else 2)
    for r, out in enumerate(layer_ranks):
        pl = out[f"{name}/placement"]
        assert (pl.dim, pl.size, pl.index) == (dim, 2, r)
        assert out[f"{name}/held"] == []
        close(out[f"{name}/y"], y)
        close(out[f"{name}/dx"], x.grad)
        close(out[f"{name}/dweight"], layer.weight.grad)
        close(out[f"{name}/dbias"], layer.bias.grad)
    for key in ("y", "dx", "dweight", "dbias"):  # replicated after the join
        assert torch.equal(layer_ranks[0][f"{name}/{key}"],
                           layer_ranks[1][f"{name}/{key}"])


def test_sharded_layer_in_bf16(layer_ranks):
    """A bf16 input: the product rounded to bf16, joined, the bias added
    in bf16 (``mixed.dense``'s order)."""
    layer, x, _ = worker.tp_layer("linear_out")
    want = (x.bfloat16() @ layer.weight.bfloat16().t()
            + layer.bias.bfloat16())
    for out in layer_ranks:
        assert out["bf16"].dtype == torch.bfloat16
        assert torch.equal(out["bf16"], want)


# -- the training step --------------------------------------------------------------

def jax_cfg():
    j = tp.jax_cfg()
    return dataclasses.replace(j, head=dataclasses.replace(
        j.head, decoder_dropout=0.0), remat_frames=False)


def write_initial(variables, path):
    """The JAX draw as a checkpoint file the trainer's ``initial`` reads."""
    payload = {k: convert({k: variables[k]}) for k in ("params",
                                                       "batch_stats")}
    torch.save(payload, path)


@pytest.fixture(scope="module")
def run_a(tmp_path_factory):
    """Data 2 x model 2 at dropout 0 from the JAX draw: 2 steps."""
    tmp = tmp_path_factory.mktemp("tp_a")
    work = tmp / "work"
    work.mkdir()
    variables = tp.init_variables(jax_cfg(), seed=0)
    write_initial(variables, work / "init.pt")
    ranks = worker.run_ranks("tp_train", 4, str(tmp / "out"), str(work), 2,
                             0.0, 1, 2)
    return ranks, variables


@pytest.fixture(scope="module")
def run_b(tmp_path_factory):
    """Data 1 x model 2 at dropout 0.1, resumed from one process's epoch
    1 (model 1) for epoch 2."""
    tmp = tmp_path_factory.mktemp("tp_b")
    work = tmp / "work"
    work.mkdir()
    worker.one_process("tp_train", str(work), 1, 0.1, 1, 1)
    m1_file = torch.load(work / "epoch_1.pt", weights_only=True)
    ranks = worker.run_ranks("tp_train", 2, str(tmp / "out"), str(work), 2,
                             0.1, 2, 2)
    return ranks, m1_file, work


def records(ranks, m=2):
    """Each step's records of one rank a data row (the global batch's
    shards), and of every rank."""
    recs = list(zip(*(r["steps"] for r in ranks)))
    return [(rec[::m], rec) for rec in recs]


def held_to_one_process(rows):
    frames, labels = worker.global_batch(rows)
    errs = step_errors(rows[0], worker.forced_step(rows[0], frames, labels))
    seed = 0
    while errs and seed < ULP_COPIES:
        errs = step_errors(rows[0], worker.forced_step(
            rows[0], one_ulp(frames, 100 + seed), labels))
        seed += 1
    return errs


@pytest.mark.parametrize("index", range(2))
def test_data2_model2_step_matches_the_one_process_step(run_a, index):
    ranks, _ = run_a
    rows, every = records(ranks)[index]
    assert len(rows) == 2 and rows[0]["dropout"] == 0.0
    assert not held_to_one_process(rows)
    assert len({(r["loss"], r["grad_norm"]) for r in every}) == 1


def test_data1_model2_resumed_step_matches_the_one_process_step(run_b):
    ranks, _, _ = run_b
    (rows, every), = records(ranks)
    assert rows[0]["step"] == 1 and rows[0]["dropout"] == 0.1
    assert not held_to_one_process(rows)
    assert len({(r["loss"], r["grad_norm"]) for r in every}) == 1


@pytest.fixture(scope="module")
def jax_step(run_a):
    """JAX's loss and gradient of run A's first step on a (2, 2) mesh with
    ``shard_params(..., min_size=1024)``."""
    ranks, variables = run_a
    rows, _ = records(ranks)[0]
    frames, labels = (x.numpy() for x in worker.global_batch(rows))
    cfg = jax_cfg()
    model = JaxPHNet(cfg)
    criterion = JaxCriterion(cfg, jcfgmod.LossConfig())

    def loss_fn(params, batch_stats, f, lab):
        (outs, _), updates = model.apply(
            {"params": params, "batch_stats": batch_stats}, f, lab,
            train=True, rngs={"dropout": jax.random.key(0)},
            mutable=["batch_stats"])
        loss, _ = criterion(outs, lab)
        return loss, updates

    mesh = jax_make_mesh(4, model_parallel=2)
    v = tp.jax_tree(variables)
    params = jax.device_put(v["params"], jax_shard_params(
        v["params"], mesh, min_size=worker.TP_MIN_SIZE))
    stats = jax.device_put(v["batch_stats"], replicate_sharding(mesh))
    bsh = batch_sharding(mesh)
    (loss, updates), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, stats, jax.device_put(frames, bsh),
                                jax.device_put(labels, bsh))
    assert params["frame"]["head"]["dyn_head_0"]["gen1_b"][
        "kernel"].sharding.spec == jax.sharding.PartitionSpec(None, "model")
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(loss=float(loss), grad_norm=float(optax.global_norm(grads)),
                grads=convert({"params": np_tree(grads)}),
                batch_stats=convert({"batch_stats": np_tree(
                    updates["batch_stats"])}))


def test_data2_model2_step_matches_jax_shard_params_step(run_a, jax_step):
    ranks, _ = run_a
    rows, _ = records(ranks)[0]
    got = rows[0]
    want = dict(jax_step, after=jax_step["batch_stats"])
    assert not step_errors(got, want)
    assert set(got["grads"]) == set(want["grads"])


def test_sharded_and_held_leaves(run_a):
    """52 kernels cut over the model axis at the dry run's geometry; the
    router's packed K2 inputs and the merged heads' kernels held whole."""
    ranks, _ = run_a
    for r, out in enumerate(ranks):
        placed = out["placements"]
        assert len(placed) == 52
        assert {pl.index for pl in placed.values()} == {r % 2}
        assert out["held"] == sorted(
            ["head.heads_sec.fc0_kernel", "head.heads_sec.fc1_kernel"]
            + [f"head.routers.{i}.{leaf}" for i in range(3)
               for leaf in ("ln_params", "taps")])


@pytest.mark.parametrize("run", ["a", "b"])
def test_ranks_hold_the_same_bits(run_a, run_b, run):
    ranks = run_a[0] if run == "a" else run_b[0]
    placed = ranks[0]["placements"]
    for _, every in records(ranks):
        for key in ("before", "after", "grads"):
            for name, x in every[0][key].items():
                for rec in every[1:]:
                    assert torch.equal(x, rec[key][name]), (key, name)
    last = max(k for k in ranks[0] if k.startswith("local"))
    whole = records(ranks)[-1][1][0]["after"]
    for r, out in enumerate(ranks):
        for name, x in out[last].items():
            if name not in placed:
                assert torch.equal(x, ranks[0][last][name]), name
            else:  # a data group's ranks hold one block of the whole
                assert torch.equal(x, ranks[r % 2][last][name]), name
                assert torch.equal(x, out["placements"][name].cut(
                    whole[name])), name


def test_checkpoint_resumes_across_model_sizes(run_b):
    """Model 1 -> 2: the ranks' resumed step starts from one process's
    file; model 2 -> 1: the file that the ranks wrote, restored by one
    process, is their gathered state, in a model 1 file's format."""
    ranks, m1_file, work = run_b
    (rows, _), = records(ranks)
    before = rows[0]["before"]
    for k, v in {**m1_file["params"], **m1_file["batch_stats"]}.items():
        assert torch.equal(before[k], v), k
    assert worker.same_bits(rows[0]["opt"], m1_file["opt_state"])
    m2_file = torch.load(work / "epoch_2.pt", weights_only=True)
    state = create_train_state(worker.small_cfg(1, 0.1), 1, "cpu")
    state, epoch, _ = CheckpointManager(str(work)).restore_state(state, 2)
    assert epoch == 2 and state.step == 2
    after = rows[0]["after"]
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, after[k]), k

    def layout(payload):
        opt = payload["opt_state"]["torch"]
        return ({name: {k: (v.shape, v.dtype) for k, v in payload[name].items()}
                 for name in ("params", "batch_stats")},
                [g["params"] for g in opt["param_groups"]],
                {i: {k: (v.shape, v.dtype) for k, v in st.items()}
                 for i, st in opt["state"].items()})

    assert layout(m2_file) == layout(m1_file)
