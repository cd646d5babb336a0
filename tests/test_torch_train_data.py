"""The training data path of the port on the CPU: the readers' train mode
(``phnet_torch.data.vil100`` / ``openlane`` with ``train=True``) against
the JAX readers, the clip loader against the JAX loader, and both
training command lines on the datasets' own files.

Readers, on the committed fixture (``tests/fixtures/torch_eval``: VIL's
one ``set: train`` video; an OpenLane ``training`` split copied here from
its validation video), at the small configurations' and the presets'
frame sizes, with the same seeds on both sides (the reader's generator
and ``TrainAugment``'s), over two epochs with a curriculum step between
them and, for OL, seeds that flip and reverse the clip:

* ``frame_names`` (the sampling, the curriculum, OL's reversal) and the
  labels (so the lane ids) equal JAX's, the points within 1e-4;
* with the JAX reader's ``cv2.imread`` swapped for the port's CPU decoder
  (libjpeg), the frames are bit-equal: both augment and normalize the
  same bytes;
* with OpenCV's own decode, the frames are within the decode's bound
  (``test_torch_eval_data.py``: 4 levels) and the augmentation's gate
  (1 level): 5 levels, 5 / 255 / 0.225 in normalized units (measured:
  0; OpenCV 5.0 decodes the fixture as libjpeg does).

The loader: JAX's indices and batches for every epoch, shard count and
``drop_last``; ``prefetch=2`` yields what ``prefetch=0`` yields; an
exception in the worker thread is raised in the consumer (the JAX loader
ends the epoch early instead); a consumer that stops early ends the
worker.

The command lines: the presets swapped for the small configurations (as
``test_torch_train_cli.py`` does), 2-frame clips, ``--device cpu``.
"""

import dataclasses
import os
import shutil
import threading
import types

import cv2
import numpy as np
import pytest
import torch

import phnet_torch.config as tcfgmod
import phnet_tpu.config as jcfgmod
import phnet_tpu.data.openlane as jax_openlane
import phnet_tpu.data.vil100 as jax_vil100
import torch_parity as tp
from phnet_torch.data import loader as port_loader
from phnet_torch.data.native_loader import decode_clip_u8
from phnet_torch.data.openlane import OpenLaneDataset
from phnet_torch.data.transforms import TrainAugment
from phnet_torch.data.vil100 import VIL100Dataset
from phnet_torch.train import __main__ as vil_cli
from phnet_torch.train import openlane as ol_cli
from phnet_torch.train import trainer
from phnet_tpu.data import loader as jax_loader
from phnet_tpu.data.transforms import TrainAugment as JaxAugment

from torch_eval_parity import FIXTURE, jax_data

DECODE_LEVELS = 4 + 1  # the decode's bound plus the augmentation's


@pytest.fixture(scope="module")
def ol_root(tmp_path_factory):
    """An OpenLane tree whose ``training`` split is the fixture's
    validation video."""
    root = tmp_path_factory.mktemp("ol_train")
    for sub in ("images", os.path.join("OpenLane-V", "label")):
        shutil.copytree(os.path.join(FIXTURE, "OpenLane", sub, "validation"),
                        root / "OpenLane" / sub / "training")
    return str(root)


def libjpeg_cv2():
    """A stand-in for the JAX readers' ``cv2`` whose ``imread`` decodes
    with the port's CPU decoder (BGR, as OpenCV returns it)."""
    shim = types.SimpleNamespace(**{k: getattr(cv2, k) for k in dir(cv2)
                                    if not k.startswith("__")})
    shim.imread = lambda path, *a: np.ascontiguousarray(
        decode_clip_u8([path])[0][..., ::-1])
    return shim


def readers(kind, size, root, seed, augment=True):
    """(port reader, JAX reader) in train mode with the same seeds."""
    if kind == "vil":
        if size == "small":
            tc, jc = tp.small_model_cfg(tcfgmod), tp.small_model_cfg(jcfgmod)
        else:
            tc, jc = (tcfgmod.vil100_config().model,
                      jcfgmod.vil100_config().model)
        kw = dict(sampled_frames=3, max_skip=1, skip_increment=1,
                  samples_per_video=2)
        aug = lambda cls: cls(tc.img_h, tc.img_w,  # noqa: E731
                              rng=np.random.default_rng(seed))
        port_cls, jax_cls, dataset = VIL100Dataset, jax_vil100.VIL100Dataset, \
            "VIL100"
    else:
        if size == "small":
            tc, jc = tp.small_ol_cfg(tcfgmod), tp.small_ol_cfg(jcfgmod)
        else:
            tc, jc = (tcfgmod.openlane_config().model,
                      jcfgmod.openlane_config().model)
        kw = dict(sampled_frames=3, max_skip=1, samples_per_video=1)
        aug = lambda cls: cls.ol_defaults(  # noqa: E731
            tc.img_h, tc.img_w, rng=np.random.default_rng(seed))
        port_cls, jax_cls, dataset = (OpenLaneDataset,
                                      jax_openlane.OpenLaneDataset,
                                      "OpenLane")
    jdata = dataclasses.replace(jax_data(jcfgmod, jc, dataset), root=root)
    port = port_cls(root, tc, train=True, device="cpu", seed=seed,
                    augment=aug(TrainAugment) if augment else None, **kw)
    ref = jax_cls(jdata, jc.lane, train=True, seed=seed,
                  augment=aug(JaxAugment) if augment else None,
                  native_decode="auto", **kw)
    return port, ref


def compare(port, ref, atol):
    """Two epochs of both readers, a curriculum step between them; returns
    the largest frame difference."""
    worst = 0.0
    for _ in range(2):
        assert len(port) == len(ref)
        for i in range(len(port)):
            got, want = port[i], ref[i]
            assert got["frame_names"] == want["frame_names"]
            np.testing.assert_array_equal(got["labels"], want["labels"])
            assert len(got["points"]) == len(want["points"])
            for g, w in zip(got["points"], want["points"]):
                assert len(g) == len(w)
                for a, b in zip(g, w):
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
            for key in ("name", "size"):
                assert got[key] == want[key]
            frames = got["frames"]
            assert frames.dtype == torch.float32 and frames.device.type \
                == "cpu"
            worst = max(worst, float(np.abs(frames.numpy()
                                            - want["frames"]).max()))
        port.increase_max_skip()
        ref.increase_max_skip()
        assert port.max_skip == ref.max_skip
    assert worst <= atol, worst
    return worst


@pytest.mark.parametrize("size", ["small", "preset"])
@pytest.mark.parametrize("kind", ["vil", "ol"])
def test_train_mode_equals_jax_on_the_same_bytes(kind, size, ol_root,
                                                 monkeypatch):
    root = FIXTURE if kind == "vil" else ol_root
    module = jax_vil100 if kind == "vil" else jax_openlane
    monkeypatch.setattr(module, "cv2", libjpeg_cv2())
    seeds = (0, 3) if size == "preset" else (0, 1, 2, 3, 5, 8)
    reversed_ = set()
    for seed in seeds:
        port, ref = readers(kind, size, root, seed)
        compare(port, ref, atol=0.0)
        names = port[0]["frame_names"]
        reversed_.add(names != sorted(names))
    if kind == "ol" and size == "small":
        assert reversed_ == {False, True}  # OL's reversal both ways


@pytest.mark.parametrize("kind", ["vil", "ol"])
def test_train_mode_equals_jax_through_opencv_decode(kind, ol_root):
    root = FIXTURE if kind == "vil" else ol_root
    for seed in (0, 1, 4):
        port, ref = readers(kind, "small", root, seed)
        compare(port, ref, atol=DECODE_LEVELS / 255.0 / 0.225)


@pytest.mark.parametrize("kind", ["vil", "ol"])
def test_train_mode_without_augment_equals_jax(kind, ol_root):
    """No augmentation: VIL (and an unflipped OL clip) take the test
    path's decoder, bit-equal to the JAX native loader; a flipped OL clip
    is resized as ``cv2.resize`` does."""
    root = FIXTURE if kind == "vil" else ol_root
    for seed in (0, 1, 2):
        port, ref = readers(kind, "small", root, seed, augment=False)
        compare(port, ref, atol=0.0)


def test_frames_stay_on_the_readers_device(ol_root):
    port, _ = readers("ol", "small", ol_root, 0)
    clip = port[0]
    assert clip["frames"].shape == (3, 96, 192, 3)
    assert clip["labels"].shape == (3, 4, port.cfg.lane.dim)
    assert port.MAX_TRAINING_SKIP == 1 and VIL100Dataset.MAX_TRAINING_SKIP \
        == 100
    port.increase_max_skip()
    assert port.max_skip == 1


class Indexed:
    """Clips tagged by their index; raises at ``fail_at``."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f"clip {i} is unreadable")
        return {"frames": np.full((2, 3, 4, 3), i, np.float32),
                "labels": np.full((2, 1, 5), i, np.float32), "name": f"v{i}",
                "frame_names": [f"{i:05d}"]}


def batches(loader):
    return [(b["frames"][:, 0, 0, 0, 0].tolist(), b["labels"].shape,
             b["infos"]) for b in loader]


@pytest.mark.parametrize("n", [7, 8])
@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_equal_jax(n, shards, drop_last):
    for shard in range(shards):
        kw = dict(batch_size=2, seed=11, num_shards=shards,
                  shard_index=shard, drop_last=drop_last)
        port = port_loader.ClipLoader(Indexed(n), prefetch=2, **kw)
        ref = jax_loader.ClipLoader(Indexed(n), prefetch=0, **kw)
        for epoch in range(3):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert port.indices() == ref._indices()
            assert len(port) == len(ref)
            got = batches(port)
            assert got == batches(ref) and len(got) == len(port)
    unshuffled = port_loader.ClipLoader(Indexed(n), batch_size=3,
                                        shuffle=False, prefetch=0)
    assert unshuffled.indices() == list(range(n))


def test_loader_prefetch_yields_what_no_prefetch_yields():
    kw = dict(batch_size=3, seed=5, drop_last=False)
    assert batches(port_loader.ClipLoader(Indexed(10), prefetch=2, **kw)) \
        == batches(port_loader.ClipLoader(Indexed(10), prefetch=0, **kw))
    clip = Indexed(3)[1]
    clip["frames"] = torch.from_numpy(clip["frames"])
    out = port_loader.collate_clips([clip, clip])
    assert torch.is_tensor(out["frames"]) and out["frames"].shape == (
        2, 2, 3, 4, 3)


# the JAX loader's worker thread dies of the exception after its ``finally``
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_exception_is_raised_in_the_consumer():
    """The port raises the worker's exception where the batches are
    consumed; the JAX loader's ``finally`` ends the epoch early and the
    error is lost."""
    kw = dict(batch_size=1, shuffle=False, prefetch=2)
    seen = []
    with pytest.raises(KeyError, match="clip 3 is unreadable"):
        for b in port_loader.ClipLoader(Indexed(6, fail_at=3), **kw):
            seen.append(b["infos"][0]["name"])
    assert seen == ["v0", "v1", "v2"]
    jax_seen = [b["infos"][0]["name"] for b in jax_loader.ClipLoader(
        Indexed(6, fail_at=3), **kw)]
    assert jax_seen == ["v0", "v1", "v2"]  # and no error


def test_stopping_early_ends_the_worker():
    def workers():
        return [t for t in threading.enumerate()
                if t.name == "ClipLoader-prefetch" and t.is_alive()]

    it = iter(port_loader.ClipLoader(Indexed(20), batch_size=1, prefetch=1))
    next(it)
    assert len(workers()) == 1
    it.close()  # joins the worker
    assert workers() == []


@pytest.fixture
def small_presets(monkeypatch):
    """The presets swapped for the small configurations (training
    settings kept, a checkpoint every epoch); records ``train``'s
    config."""
    seen = {}
    real_train = trainer.train

    def spy(cfg, *args, **kw):
        seen["cfg"] = cfg
        return real_train(cfg, *args, verbose=False, **kw)

    monkeypatch.setattr(trainer, "train", spy)

    def small(real, model):
        cfg = real()
        return dataclasses.replace(cfg, model=model, train=dataclasses.
                                   replace(cfg.train, epoch_per_test=1))

    real_vil, real_ol = tcfgmod.vil100_config, tcfgmod.openlane_config
    monkeypatch.setattr(tcfgmod, "vil100_config", lambda: small(
        real_vil, tp.small_model_cfg(tcfgmod)))
    monkeypatch.setattr(tcfgmod, "openlane_config",
                        lambda n_offsets=72: small(
                            real_ol, tp.small_ol_cfg(tcfgmod)))
    return seen


COMMON = ["--epochs", "1", "--frames", "2", "--device", "cpu"]


@pytest.mark.parametrize("assigner", ["hungarian", "dynamic_k"])
def test_vil_cli_trains_on_the_fixture_and_resumes(small_presets, tmp_path,
                                                   assigner, capsys):
    argv = COMMON + ["--data-root", FIXTURE, "--workdir", str(tmp_path),
                     "--assigner", assigner]
    history = vil_cli.main(argv)
    assert len(history) == 1 and np.isfinite(history[0])
    cfg = small_presets["cfg"]
    assert cfg.model.train_assigner == assigner
    assert cfg.model.compute_dtype == "bfloat16"
    assert (cfg.train.max_skip, cfg.train.samples_per_video) == (5, 2)
    out = capsys.readouterr().out
    assert "steps 2: wall p50" in out and "--synthetic" not in out
    history = vil_cli.main(argv[:1] + ["2"] + argv[2:] + ["--resume"])
    assert len(history) == 1 and np.isfinite(history[0])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best.pt", "epoch_1.pt", "epoch_2.pt", "log.txt"]


def test_openlane_cli_trains_on_a_training_tree(small_presets, tmp_path,
                                                ol_root):
    argv = COMMON + ["--data-root", ol_root, "--workdir", str(tmp_path),
                     "--fp32"]
    history = ol_cli.main(argv)
    assert len(history) == 1 and np.isfinite(history[0])
    cfg = small_presets["cfg"]
    assert (cfg.train.max_skip, cfg.train.samples_per_video) == (1, 1)
    assert cfg.model.compute_dtype == "float32"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best.pt", "epoch_1.pt", "log.txt"]


@pytest.mark.parametrize("cli,root", [(vil_cli, FIXTURE), (ol_cli, None)])
def test_clis_on_data_refuse_more_devices(cli, root, ol_root):
    """On the dataset too, ``--devices`` refuses a global batch that its
    ranks do not divide (before any reader is built)."""
    with pytest.raises(SystemExit, match="a global batch of 3 clips does "
                                         "not split over 2 ranks"):
        cli.main(["--data-root", root or ol_root, "--devices", "2",
                  "--batch", "3"])
