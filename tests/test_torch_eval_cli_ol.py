"""``python -m phnet_torch.run.test_ol --variant single`` end to end on
the committed fixture's OpenLane-V validation video, at the small
single-head geometry of ``tests/torch_parity.py`` with bridged weights read
from a port checkpoint: the same ``.lines.txt`` files, byte for byte, as
the JAX ``InferencePipeline.run_and_emit`` (memory reset at each chunk, as
``test_ol.py`` runs it) over the JAX reader's clip. The command lines'
other inputs: ``--synthetic`` clips after ``--train-first`` steps, and
``--quantize w8``, run and emit a line file a frame."""

import os

import phnet_torch.config as tcfg
import phnet_tpu.config as jcfg
from phnet_torch.run import test_ol as t_test_ol
from phnet_tpu.data.openlane import OpenLaneDataset as JaxOL
from phnet_tpu.pipeline import InferencePipeline as JaxPipeline

import torch_parity as tp
from torch_eval_parity import (CHUNK, FIXTURE, assert_trees_byte_equal,
                               jax_data, lane_count, small_ol,
                               write_checkpoint)


def test_test_ol_lines_byte_equal_to_jax(tmp_path):
    variables = tp.init_variables(tp.small_ol_cfg(jcfg), seed=0)
    jc = small_ol(jcfg)
    jpipe = JaxPipeline(jc, tp.jax_tree(variables), chunk=CHUNK,
                        memory_window=jc.model.memory.window,
                        reset_memory_per_chunk=True)
    jpipe.run_and_emit(
        JaxOL(jax_data(jcfg, jc.model, "OpenLane"), jc.model.lane,
              train=False, native_decode="always"),
        str(tmp_path / "jax_pred"), None, fmt="ol")
    ckpt = write_checkpoint(small_ol(tcfg), variables, tmp_path / "ckpt")
    out = t_test_ol.main(
        ["--data-root", FIXTURE, "--checkpoint", ckpt, "--chunk", str(CHUNK),
         "--variant", "single", "--pred-dir", str(tmp_path / "pred"),
         "--device", "cpu"], cfg=small_ol(tcfg))
    assert_trees_byte_equal(tmp_path / "jax_pred", tmp_path / "pred")
    assert out["stats"]["frames"] == 4
    assert lane_count(tmp_path / "pred") > 0


def test_synthetic_clips_after_overfit_steps(tmp_path, capsys):
    """``test_vil --synthetic --train-first 2 --evaluate`` and ``test_ol
    --synthetic --quantize w8``, small geometries, on the CPU. Synthetic
    clips write their ground truth in the predictions' frame, so
    ``--evaluate`` gives no warning there."""
    from phnet_torch.run import test_vil as t_test_vil
    from torch_eval_parity import small_vil

    out = t_test_vil.main(
        ["--synthetic", "--synthetic-videos", "1", "--synthetic-frames", "3",
         "--train-first", "2", "--evaluate", "--pred-dir",
         str(tmp_path / "vil"), "--anno-dir", str(tmp_path / "vil_anno"),
         "--device", "cpu"], cfg=small_vil(tcfg))
    assert out["stats"]["frames"] == 3 and out["metric"]["FN"] >= 0
    assert "not an accuracy" not in capsys.readouterr().err
    assert len(os.listdir(tmp_path / "vil" / "synth_000")) == 3
    out = t_test_ol.main(
        ["--synthetic", "--synthetic-videos", "2", "--synthetic-frames", "2",
         "--quantize", "w8", "--pred-dir", str(tmp_path / "ol"),
         "--device", "cpu"], cfg=small_ol(tcfg))
    assert out["stats"]["frames"] == 4
    assert sorted(os.listdir(tmp_path / "ol")) == ["synth_000", "synth_001"]
