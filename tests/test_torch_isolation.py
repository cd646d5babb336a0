"""The port stands alone: no module of ``phnet_torch``, nothing in
``chip_smoke.py`` and nothing in ``tools/torch_serving_profile.py`` or
``tools/torch_train_profile.py`` imports JAX, flax, optax or the JAX
package, nor OpenCV, PyYAML or PIL (the card's machine has none of them
to count on), and its entry points run on the card by default (so they
raise where there is none), the OpenLane-V presets' included."""

import ast
from pathlib import Path

import pytest
import torch

from phnet_torch.config import (openlane_config, openlane_multiscale_config,
                                openlane_propagate_config,
                                vil100_config)
from phnet_torch.models import PHNet
from phnet_torch.pipeline import InferencePipeline
from phnet_torch.serving import StreamingServer
from phnet_torch.train.state import create_train_state
from phnet_torch.train.trainer import train

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "phnet_tpu", "cv2", "yaml",
             "PIL")


def port_sources():
    return (sorted((REPO / "phnet_torch").rglob("*.py"))
            + [REPO / "tools" / "torch_serving_profile.py",
               REPO / "tools" / "torch_train_profile.py",
               REPO / "chip_smoke.py"])


def imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_exist():
    names = {p.relative_to(REPO).as_posix() for p in port_sources()}
    assert {"chip_smoke.py", "phnet_torch/ops/nms.py",
            "phnet_torch/ops/router_chain.py",
            "phnet_torch/ops/quant.py", "phnet_torch/ops/w8_matmul.py",
            "phnet_torch/pipeline.py", "phnet_torch/evaluation/emit.py",
            "phnet_torch/serving.py", "phnet_torch/ops/hungarian.py",
            "phnet_torch/losses/focal.py", "phnet_torch/losses/assign.py",
            "phnet_torch/losses/criterion.py",
            "phnet_torch/train/optimizer.py", "phnet_torch/train/state.py",
            "phnet_torch/train/step.py", "phnet_torch/train/checkpoint.py",
            "phnet_torch/train/trainer.py", "phnet_torch/train/__main__.py",
            "phnet_torch/train/cli.py", "phnet_torch/train/openlane.py",
            "phnet_torch/data/synthetic.py", "phnet_torch/data/loader.py",
            "tools/torch_train_profile.py", "phnet_torch/models/head_ms.py",
            "phnet_torch/models/revcol.py",
            "phnet_torch/ops/sampler.py", "phnet_torch/models/head_v3.py",
            "tools/torch_serving_profile.py",
            "phnet_torch/data/vil100.py", "phnet_torch/data/openlane.py",
            "phnet_torch/data/native_loader.py",
            "phnet_torch/data/transforms.py",
            "phnet_torch/data/sampling.py",
            "phnet_torch/evaluation/culane_metric.py",
            "phnet_torch/evaluation/native_eval.py",
            "phnet_torch/evaluation/temporal.py",
            "phnet_torch/evaluation/fixtures.py",
            "phnet_torch/evaluation/tusimple_acc.py",
            "phnet_torch/utils/torch_import.py",
            "phnet_torch/run/test_vil.py", "phnet_torch/run/test_ol.py",
            "phnet_torch/run/evaluate.py",
            "phnet_torch/parallel/__init__.py",
            "phnet_torch/parallel/mesh.py",
            "phnet_torch/parallel/multihost.py",
            "phnet_torch/parallel/tensor.py"} <= names
    assert (REPO / "phnet_torch" / "csrc" / "w8_matmul.cu").is_file()
    for src in ("data/native/clip_loader.cpp",
                "data/native/nvjpeg_decode.cpp",
                "evaluation/native/culane_eval.cpp"):
        assert (REPO / "phnet_torch" / src).is_file()


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_imports(path):
    bad = sorted(set(imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("line", [
    "import cv2", "import yaml as y", "from PIL import Image",
    "import numpy, jax.numpy", "from phnet_tpu.data import vil100",
    "import flax.linen as nn"])
def test_scan_catches_a_planted_import(line, tmp_path):
    """The scan above fails on a module with a forbidden import, written
    at top level or inside a function."""
    path = tmp_path / "planted.py"
    path.write_text(f"import os\n\n\ndef f():\n    {line}\n")
    assert set(imported_roots(path)) & set(FORBIDDEN)
    path.write_text(f"{line}\n")
    assert set(imported_roots(path)) & set(FORBIDDEN)


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = vil100_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingServer(cfg, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        PHNet(cfg.model)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferencePipeline(cfg, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(cfg, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg, None, [], str(tmp_path))


@pytest.mark.parametrize("preset", [openlane_config,
                                    openlane_multiscale_config,
                                    openlane_propagate_config],
                         ids=lambda f: f.__name__)
def test_openlane_entry_points_default_to_the_card(preset):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = preset()
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingServer(cfg, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        PHNet(cfg.model)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferencePipeline(cfg, {})


@pytest.mark.parametrize("preset", [openlane_multiscale_config,
                                    openlane_propagate_config],
                         ids=lambda f: f.__name__)
def test_openlane_training_defaults_to_the_card(preset, tmp_path):
    """The multi-scale and prior-propagation heads' training entry points
    (the train state, ``train()``, the OL command line) run on the card
    unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from phnet_torch.train import openlane as ol_cli

    cfg = preset()
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(cfg, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg, None, [], str(tmp_path))
    variant = {openlane_multiscale_config: "multiscale",
               openlane_propagate_config: "propagate"}[preset]
    with pytest.raises(RuntimeError, match="CUDA"):
        ol_cli.main(["--synthetic", "--variant", variant, "--epochs", "1",
                     "--synthetic-videos", "1", "--frames", "1",
                     "--workdir", str(tmp_path)])
