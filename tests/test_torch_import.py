"""The reference-checkpoint import of the port
(``phnet_torch.utils.torch_import``) against the JAX package's
(``phnet_tpu.utils.torch_import``) followed by the parameter bridge
(``phnet_torch.convert``), on the CPU.

A seeded state dict with the reference's key names and layouts
(``RouterWithB``: torchvision's ResNet, mmdet's FPN, the ``RouterV2`` head
of VIL-100 or the ``DetNetV2`` head of OpenLane-V with its offsets stack
and learned positions; seeded weights of the JAX model exported under
those names), wrapped as the reference's trainers save it
(DDP's ``module.``, ``{'state_dict': ...}``) and carrying keys the model
has no use for, is imported both ways at the small geometries of
``tests/torch_parity.py``: every tensor bit-equal. A missing or misshapen
key raises. ``load_pretrained_backbone`` likewise with torchvision-named
weights alone. ``python -m phnet_torch.run.test_vil --torch-checkpoint``
on a saved reference checkpoint writes the lines that ``--checkpoint``
writes for the same weights imported by the JAX package and bridged.
"""

import os

import numpy as np
import pytest
import torch

import phnet_torch.config as tcfg
import phnet_tpu.config as jcfg
from phnet_torch.convert import convert
from phnet_torch.models import PHNet
from phnet_torch.run import test_vil as t_test_vil
from phnet_torch.utils import torch_import as t_imp
from phnet_tpu.utils import torch_import as j_imp

import torch_parity as tp
from torch_eval_parity import (FIXTURE, assert_trees_byte_equal, lane_count,
                               reference_state_dict, small_vil,
                               write_checkpoint)


CONFIGS = {"vil": tp.small_model_cfg, "ol": tp.small_ol_cfg}


def shifted(variables):
    """A copy of ``variables`` with every leaf moved by 1: the tree the
    JAX importer writes into, so that a leaf it leaves alone shows."""
    return {k: shifted(v) if isinstance(v, dict) else np.asarray(v) + 1.0
            for k, v in variables.items()}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    make = CONFIGS[request.param]
    variables = tp.init_variables(make(jcfg), seed=7)
    ref = reference_state_dict(variables)
    shell = shifted(variables)
    target = PHNet(make(tcfg), device="cpu").state_dict()
    return request.param, shell, ref, target


def test_import_equals_jax_import_and_bridge(case):
    kind, shell, ref, target = case
    ckpt = {"state_dict": {"module." + k: torch.from_numpy(v)
                           for k, v in ref.items()}, "epoch": 3}
    want = convert(j_imp.load_reference_checkpoint(
        shell, {"module." + k: v for k, v in ref.items()}))
    got = t_imp.import_reference_checkpoint(ckpt, target)
    assert set(got) == set(want) == set(target)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    if kind == "ol":
        assert "head.heads_fir.out2_kernel" in got
        assert "head.pos_encoding.embedding" in got
    # the import replaced every leaf of the shell
    before = convert(shell)
    assert all(not torch.equal(before[k], got[k]) for k in got)


def test_import_raises_on_a_missing_or_misshapen_key(case):
    _, _, ref, target = case
    for key in ("detNet.router.DWNets.1.2.3.weight",
                "backbone.neck.fpn_convs.2.conv.bias",
                "detNet.transformer_Dec.layers.1.linear2.weight",
                "backbone.backbone.model.layer4.1.bn2.running_var"):
        assert key in ref
        missing = {k: v for k, v in ref.items() if k != key}
        with pytest.raises(KeyError, match=key.replace(".", r"\.")):
            t_imp.import_reference_checkpoint(missing, target)
        bad = dict(ref)
        bad[key] = np.zeros(ref[key].shape[:-1] + (ref[key].shape[-1] + 1,),
                            np.float32)
        with pytest.raises(ValueError, match="shape"):
            t_imp.import_reference_checkpoint(bad, target)


def test_pretrained_backbone_equals_jax(case):
    _, shell, ref, target = case
    pre = "backbone.backbone.model."
    resnet = {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}
    start = convert(shell)
    want = convert(j_imp.load_pretrained_backbone(shell, resnet))
    got = t_imp.load_pretrained_backbone(start, resnet)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert (k.startswith("encoder.backbone.")
                or torch.equal(got[k], start[k]))
    with pytest.raises(KeyError, match="layer2"):
        t_imp.load_pretrained_backbone(start, {
            k: v for k, v in resnet.items() if not k.startswith("layer2")})


def test_test_vil_runs_a_reference_checkpoint(tmp_path):
    variables = tp.init_variables(tp.small_model_cfg(jcfg), seed=7)
    ref = reference_state_dict(variables)
    shell = shifted(variables)
    path = str(tmp_path / "best.pth.tar")
    torch.save({"state_dict": {"module." + k: torch.from_numpy(v)
                               for k, v in ref.items()}, "epoch": 3}, path)
    bridged = write_checkpoint(
        small_vil(tcfg),
        j_imp.load_reference_checkpoint(shell, ref), tmp_path / "ckpt")
    for flag, value, out in (("--torch-checkpoint", path, "imported"),
                             ("--checkpoint", bridged, "bridged")):
        t_test_vil.main(["--data-root", FIXTURE, flag, value, "--chunk", "3",
                         "--pred-dir", str(tmp_path / out), "--anno-dir",
                         str(tmp_path / (out + "_anno")), "--device", "cpu"],
                        cfg=small_vil(tcfg))
    assert_trees_byte_equal(tmp_path / "bridged", tmp_path / "imported")
    assert len(os.listdir(tmp_path / "imported")) == 2  # the test videos
    assert lane_count(tmp_path / "imported") > 0
