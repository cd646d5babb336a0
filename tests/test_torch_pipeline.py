"""The port's clip pipeline (``phnet_torch.pipeline.InferencePipeline``)
against the JAX package's, on the small configuration: clips of 5 and 4
frames in chunks of 3, so that the last chunk is padded and the memory is
carried across chunks, emitted as CULane ``.lines.txt`` files.

Tolerances: lane counts per file equal and points within 1 px (the VIL
format writes integer pixels, so a sub-pixel difference can move a
coordinate by one); the ground-truth files, written by the port's own copy
of the emitter, are byte-equal. In ``"w8"`` the JAX pipeline quantizes its
weights inside the compiled graph (a reciprocal scale) and the port once
outside it (a division): a scale one ulp apart and rare bf16 rounding
flips stay sub-pixel.
"""

import dataclasses
import os

import numpy as np
import pytest

import phnet_torch.config as tcfg
import phnet_tpu.config as jcfg
from phnet_torch.convert import convert
from phnet_torch.evaluation.emit import read_lines_txt
from phnet_torch.pipeline import InferencePipeline as TorchPipeline
from phnet_tpu.pipeline import InferencePipeline as JaxPipeline

import torch_parity as tp

CHUNK = 3
SIZE = (720, 1280)


def clips():
    """Two in-memory VIL-style clips (the pipeline's duck-typed dataset)."""
    out = []
    for i, t in enumerate((5, 4)):
        frames = tp.seeded_frames(40 + i, (t, 64, 128, 3))
        pts = [np.array([[100.0 + 10 * j, 700.0 - 50 * k] for k in range(4)])
               for j in range(2)]
        out.append({"frames": frames, "size": SIZE, "cut": 252,
                    "name": f"clip_{i}",
                    "frame_names": [f"{n:05d}" for n in range(t)],
                    "points": [pts] * t})
    return out


def lines_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.fixture(scope="module")
def weights():
    return tp.init_variables(tp.jax_cfg(), seed=0)


@pytest.fixture(scope="module")
def pipelines(weights):
    """A function of a quantize mode giving (JAX pipeline, port pipeline),
    each built once."""
    made = {}

    def get(mode):
        if mode not in made:
            made[mode] = (
                JaxPipeline(jcfg.Config(model=dataclasses.replace(
                    tp.jax_cfg(), quantize=mode)), tp.jax_tree(weights),
                    chunk=CHUNK),
                TorchPipeline(tcfg.Config(model=dataclasses.replace(
                    tp.torch_cfg(), quantize=mode)), convert(weights),
                    chunk=CHUNK, device="cpu"))
        return made[mode]

    return get


def compare_emission(jpipe, tpipe, data, tmp_path, atol=1.0):
    """Both pipelines' ``run_and_emit`` over ``data``: the same files,
    lane counts per file equal, points within ``atol`` px, ground truth
    byte-equal. Returns the lane count."""
    jstats = jpipe.run_and_emit(data, str(tmp_path / "jax_pred"),
                                str(tmp_path / "jax_anno"))
    tstats = tpipe.run_and_emit(data, str(tmp_path / "torch_pred"),
                                str(tmp_path / "torch_anno"))
    n_frames = sum(len(c["frame_names"]) for c in data)
    assert tstats["frames"] == jstats["frames"] == n_frames
    assert tstats["videos"] == jstats["videos"] == [c["name"] for c in data]
    files = lines_files(tmp_path / "jax_pred")
    assert files == lines_files(tmp_path / "torch_pred")
    assert len(files) == n_frames
    n_lanes = 0
    for f in files:
        jl = read_lines_txt(str(tmp_path / "jax_pred" / f))
        tl = read_lines_txt(str(tmp_path / "torch_pred" / f))
        assert len(tl) == len(jl), f
        for a, b in zip(jl, tl):
            assert len(a) == len(b), f
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=f)
        n_lanes += len(tl)
        ja = (tmp_path / "jax_anno" / f).read_bytes()
        assert (tmp_path / "torch_anno" / f).read_bytes() == ja
    return n_lanes


@pytest.mark.parametrize("mode", ["none", "w8"])
def test_pipeline_matches_jax(mode, pipelines, tmp_path):
    jpipe, tpipe = pipelines(mode)
    assert tpipe.memory_window == jpipe.memory_window == 128
    assert compare_emission(jpipe, tpipe, clips(), tmp_path) > 0


def test_clip_without_cut_emits_as_jax(pipelines, tmp_path):
    """A VIL clip without ``cut`` (as the synthetic clips of both packages
    are) is emitted with a cut of 0 by both pipelines: the predicted lines
    byte-equal, the ground truth too."""
    jpipe, tpipe = pipelines("none")
    data = [{k: v for k, v in c.items() if k != "cut"} for c in clips()]
    assert compare_emission(jpipe, tpipe, data, tmp_path, atol=0.0) > 0
    for f in lines_files(tmp_path / "jax_pred"):
        assert ((tmp_path / "torch_pred" / f).read_bytes()
                == (tmp_path / "jax_pred" / f).read_bytes()), f


def test_reset_memory_per_chunk(weights):
    """With the reset, a chunk decodes as if it began a new video."""
    pipe = TorchPipeline(tcfg.Config(model=tp.torch_cfg()), convert(weights),
                         chunk=CHUNK, reset_memory_per_chunk=True,
                         device="cpu")
    frames = tp.seeded_frames(40, (6, 64, 128, 3))
    whole, _ = pipe.run_video(frames)
    second, _ = pipe.run_video(frames[CHUNK:])
    assert len(whole) == 6
    for a, b in zip(whole[CHUNK:], second):
        assert len(a) == len(b)
        for la, lb in zip(a, b):
            np.testing.assert_array_equal(la.points, lb.points)
