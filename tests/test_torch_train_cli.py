"""The training command lines (``python -m phnet_torch.train`` and
``python -m phnet_torch.train.openlane``) on one-epoch synthetic runs on
the CPU, and OpenLane-V's synthetic labels against the JAX package's
label encoder.

The command lines build the full-width presets; here the presets are
swapped for the small configurations of ``torch_parity`` (their training
settings kept), so that an epoch of 2 clips of 2 frames takes seconds.
Each run must train the compute dtype the flags ask for (bfloat16 unless
``--fp32``, as ``train_vil.py`` and ``train_ol.py``) and the variant
(OpenLane-V's ``--variant single``, ``multiscale`` or ``propagate``),
write its log and checkpoints, resume, and end with finite epoch losses.
``--devices 2 --device cpu`` trains over two gloo processes. What the
port does not train refuses clearly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
import phnet_torch.config as tcfgmod
import phnet_tpu.config as jcfgmod
import torch_parity as tp
from phnet_torch.data.synthetic import synthetic_clip
from phnet_torch.train import __main__ as vil_cli
from phnet_torch.train import openlane as ol_cli
from phnet_torch.train import trainer
from phnet_tpu.geometry import encode_lane_label as jax_encode


def small(preset_cfg, model):
    """``preset_cfg`` with the small model and one checkpoint an epoch."""
    return dataclasses.replace(preset_cfg, model=model, train=dataclasses.
                               replace(preset_cfg.train, epoch_per_test=1))


@pytest.fixture
def trained(monkeypatch):
    """Swap the presets for small ones and record what ``train`` gets."""
    seen = {}
    real_train = trainer.train

    def spy(cfg, *args, **kw):
        seen["cfg"] = cfg
        return real_train(cfg, *args, verbose=False, **kw)

    monkeypatch.setattr(trainer, "train", spy)
    real_vil = tcfgmod.vil100_config
    monkeypatch.setattr(tcfgmod, "vil100_config", lambda: small(
        real_vil(), tp.torch_cfg()))
    real_ol = tcfgmod.openlane_config

    def ol(n_offsets=72):
        seen["n_offsets"] = n_offsets
        return small(real_ol(n_offsets), tp.small_ol_cfg(tcfgmod))

    monkeypatch.setattr(tcfgmod, "openlane_config", ol)
    for preset, small_cfg in (("openlane_multiscale_config",
                               tp.small_ms_cfg),
                              ("openlane_propagate_config",
                               tp.small_v3_cfg)):
        real = getattr(tcfgmod, preset)
        monkeypatch.setattr(tcfgmod, preset, (
            lambda real, small_cfg: lambda n_offsets=72: small(
                real(n_offsets), small_cfg(tcfgmod)))(real, small_cfg))
    return seen


COMMON = ["--synthetic", "--epochs", "1", "--frames", "2",
          "--synthetic-videos", "2", "--device", "cpu"]


@pytest.mark.parametrize("fp32", [False, True])
def test_vil_cli_trains_in_the_asked_dtype(trained, tmp_path, fp32):
    argv = COMMON + ["--workdir", str(tmp_path)] + (["--fp32"] if fp32
                                                    else [])
    history = vil_cli.main(argv)
    assert len(history) == 1 and np.isfinite(history[0])
    m = trained["cfg"].model
    assert m.compute_dtype == ("float32" if fp32 else "bfloat16")
    assert m.lane.n_lengths == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best.pt", "epoch_1.pt", "log.txt"]


@pytest.mark.parametrize("fp32", [False, True])
def test_openlane_cli_trains_router4ol(trained, tmp_path, fp32):
    argv = COMMON + ["--workdir", str(tmp_path), "--n-offsets", "24"] + (
        ["--fp32"] if fp32 else [])
    history = ol_cli.main(argv)
    assert len(history) == 1 and np.isfinite(history[0])
    m = trained["cfg"].model
    assert trained["n_offsets"] == 24
    assert m.compute_dtype == ("float32" if fp32 else "bfloat16")
    assert (m.head.variant, m.lane.n_lengths, m.routing) == (
        "single", 1, "soft")
    assert trained["cfg"].train.loss.style == "blend_cls"
    assert (tmp_path / "log.txt").exists()


def test_openlane_cli_resumes(trained, tmp_path):
    """A second epoch resumed from the first's checkpoint: the step count
    and the curriculum pick up where they stopped."""
    argv = COMMON + ["--workdir", str(tmp_path)]
    ol_cli.main(argv)
    history = ol_cli.main(argv[:2] + ["2"] + argv[3:] + ["--resume"])
    assert len(history) == 1 and np.isfinite(history[0])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best.pt", "epoch_1.pt", "epoch_2.pt", "log.txt"]


VARIANT_HEADS = {"multiscale": ("multi", False),
                 "propagate": ("single", True)}


@pytest.mark.parametrize("fp32", [False, True])
@pytest.mark.parametrize("variant", list(VARIANT_HEADS))
def test_openlane_cli_trains_each_variant(trained, tmp_path, variant,
                                          fp32):
    """``--variant multiscale`` (``Router4OLV2``) and ``--variant
    propagate`` (``Router4OLV3``) train one epoch in the asked dtype."""
    argv = COMMON + ["--workdir", str(tmp_path), "--variant", variant] + (
        ["--fp32"] if fp32 else [])
    history = ol_cli.main(argv)
    assert len(history) == 1 and np.isfinite(history[0])
    m = trained["cfg"].model
    assert m.compute_dtype == ("float32" if fp32 else "bfloat16")
    assert (m.head.variant, m.head.propagate_priors) == VARIANT_HEADS[
        variant]
    assert trained["cfg"].train.loss.style == "blend_cls"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best.pt", "epoch_1.pt", "log.txt"]


@pytest.mark.parametrize("variant", list(VARIANT_HEADS))
def test_openlane_cli_resumes_each_variant(trained, tmp_path, variant):
    """A second epoch of each variant resumed from the first's
    checkpoint (in bf16, the default)."""
    argv = COMMON + ["--workdir", str(tmp_path), "--variant", variant]
    ol_cli.main(argv)
    history = ol_cli.main(argv[:2] + ["2"] + argv[3:] + ["--resume"])
    assert len(history) == 1 and np.isfinite(history[0])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best.pt", "epoch_1.pt", "epoch_2.pt", "log.txt"]


def test_what_is_not_ported_refuses_clearly(tmp_path):
    """An assigner the JAX trainers cannot select when the config is
    built; quantized training in the training forward and the trainer;
    a ``--data-root`` without the dataset, for every variant."""
    import torch

    with pytest.raises(ValueError, match="train_assigner.*'one2many'"):
        dataclasses.replace(tp.small_v3_cfg(tcfgmod),
                            train_assigner="one2many")
    w8 = tp.small_v3_cfg(tcfgmod, quantize="w8")
    model = tp.torch_model(w8, tp.init_variables(tp.small_v3_cfg(jcfgmod)))
    model.train()
    with pytest.raises(ValueError, match="inference-only"):
        model.train_forward(torch.zeros((1, 1, 96, 192, 3)),
                            torch.zeros((1, 1, 4, w8.lane.dim)))
    with pytest.raises(ValueError, match="inference-only"):
        trainer.train(tcfgmod.Config(model=w8), None, None, str(tmp_path))
    for variant in ("single", "multiscale", "propagate"):
        with pytest.raises(SystemExit, match="no OpenLane-V at "
                                             "/data/OpenLane/OpenLane"):
            ol_cli.main(["--data-root", "/data/OpenLane", "--variant",
                         variant])


@pytest.mark.parametrize("argv,match", [
    (["--data-root", "/data/OpenLane"], "no OpenLane-V at .*; pass the "
                                        "directory holding OpenLane/"),
    (["--synthetic", "--devices", "2", "--batch", "3"],
     "a global batch of 3 clips does not split over 2 ranks"),
])
def test_openlane_cli_clear_errors(argv, match):
    with pytest.raises(SystemExit, match=match):
        ol_cli.main(argv)


def test_vil_cli_trains_over_two_cpu_processes(tmp_path):
    """``--devices 2 --device cpu``: the command line starts two gloo
    ranks, which train one epoch of the small model (4 clips, a global
    batch of 2: two steps); rank 0 alone writes the log (one header, one
    epoch line) and the checkpoints (``tests/_torch_dist_worker.py``, case
    ``cli``, in a subprocess with a time limit)."""
    work = tmp_path / "work"
    (out,) = worker.run_ranks("cli", 1, str(tmp_path / "out"), str(work))
    assert len(out["history"]) == 1 and np.isfinite(out["history"][0])
    assert sorted(p.name for p in work.iterdir()) == [
        "best.pt", "epoch_1.pt", "log.txt"]
    lines = (work / "log.txt").read_text().splitlines()
    assert [l.split("\t")[0] for l in lines] == ["Epoch", "1"]
    saved = torch.load(work / "epoch_1.pt", weights_only=True)
    assert saved["step"] == 2 and saved["epoch"] == 1


def test_vil_cli_joins_a_torchrun_group(tmp_path, monkeypatch):
    """Under torchrun's variables (here a group of one gloo rank) the
    command line joins the group from the environment, trains as one
    process does, bit for bit, and leaves the group."""
    import torch.distributed as dist

    argv = ["--synthetic", "--epochs", "1", "--frames", "2",
            "--synthetic-videos", "2", "--fp32", "--device", "cpu"]
    alone = vil_cli.main(argv + ["--workdir", str(tmp_path / "alone")],
                         cfg=worker.small_cfg())
    for key, value in (("MASTER_ADDR", "127.0.0.1"),
                       ("MASTER_PORT", str(worker.free_port())),
                       ("WORLD_SIZE", "1"), ("RANK", "0"),
                       ("LOCAL_RANK", "0")):
        monkeypatch.setenv(key, value)
    grouped = vil_cli.main(argv + ["--workdir", str(tmp_path / "group")],
                           cfg=worker.small_cfg())
    assert not dist.is_initialized()
    assert grouped == alone and np.isfinite(alone).all()
    a, b = (torch.load(tmp_path / d / "epoch_1.pt", weights_only=True)
            for d in ("alone", "group"))
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_openlane_synthetic_labels_equal_jax_encoder(seed):
    """OL synthetic clips (one length field, 4 lanes, 72 offsets, the OL
    preset's image size): their labels equal the JAX package's
    ``encode_lane_label`` on the same lane points."""
    m = tcfgmod.openlane_config().model
    clip = synthetic_clip(seed, 3, m.img_h, m.img_w, spec=m.lane,
                          max_lanes=m.max_lanes)
    assert clip["labels"].shape == (3, 4, 5 + 1 + 72)
    ref_spec = jcfgmod.openlane_config().model.lane
    for t in range(3):
        lanes = [list(map(tuple, p)) for p in clip["points"][t]]
        ref = jax_encode(lanes, list(range(len(lanes))), ref_spec, m.img_h,
                         m.img_w, m.max_lanes)
        np.testing.assert_array_equal(clip["labels"][t], ref)
        assert (clip["labels"][t][:, 1] == 1.0).sum() >= 1
