"""The port's VIL-100 evaluation command lines end to end on the committed
fixture (``tests/fixtures/torch_eval``), at the small geometry of
``tests/torch_parity.py`` with weights drawn for the JAX package and
bridged to the port (``phnet_torch.convert``), which the command line
reads from a port checkpoint:

* ``python -m phnet_torch.run.test_vil`` over the VIL-100 test videos
  writes the same ``.lines.txt`` files, byte for byte, as the JAX
  ``InferencePipeline.run_and_emit`` over the JAX reader's clips (the
  ground truth is the port's own, in the image's frame); its
  ``--evaluate`` metric equals the JAX package's on the same files;
* ``python -m phnet_torch.run.evaluate --native --temporal`` prints what
  the root ``evaluate.py`` prints on the same directories.
"""

import ast
import contextlib
import importlib
import io
import os
import sys

import pytest
import torch

import phnet_torch.config as tcfg
import phnet_tpu.config as jcfg
from phnet_torch.run import evaluate as t_evaluate
from phnet_torch.run import test_ol as t_test_ol
from phnet_torch.run import test_vil as t_test_vil
from phnet_tpu.data.vil100 import VIL100Dataset as JaxVIL
from phnet_tpu.pipeline import InferencePipeline as JaxPipeline

import torch_parity as tp
from torch_eval_parity import (CHUNK, FIXTURE, REPO, assert_trees_byte_equal,
                               files, jax_data, lane_count, small_vil,
                               write_checkpoint)

@pytest.fixture(scope="module")
def vil_run(tmp_path_factory):
    """Both packages over the VIL fixture: (tmp dir, port's return)."""
    tmp = tmp_path_factory.mktemp("vil")
    variables = tp.init_variables(tp.jax_cfg(), seed=0)
    jc = small_vil(jcfg)
    jpipe = JaxPipeline(jc, tp.jax_tree(variables), chunk=CHUNK)
    jpipe.run_and_emit(
        JaxVIL(jax_data(jcfg, jc.model), jc.model.lane, train=False,
               native_decode="always"),
        str(tmp / "jax_pred"), str(tmp / "jax_anno"), fmt="vil")
    ckpt = write_checkpoint(small_vil(tcfg), variables, tmp / "ckpt")
    out = t_test_vil.main(
        ["--data-root", FIXTURE, "--checkpoint", ckpt, "--chunk", str(CHUNK),
         "--pred-dir", str(tmp / "pred"), "--anno-dir", str(tmp / "anno"),
         "--evaluate", "--device", "cpu"], cfg=small_vil(tcfg))
    return tmp, out


def test_test_vil_lines_byte_equal_to_jax(vil_run):
    tmp, out = vil_run
    assert_trees_byte_equal(tmp / "jax_pred", tmp / "pred")
    # the prediction trees only: the port writes the ground truth in the
    # image's frame, the predictions' (``image_points``, as the
    # reference's generate_anno), the JAX package in the model's
    # (``test_torch_eval_gt_frame.py`` holds the port's)
    assert files(tmp / "jax_anno") == files(tmp / "anno")
    assert out["stats"]["frames"] == 8  # two test videos of 4 frames
    assert out["stats"]["videos"] == ["0_Road001_Trim003_frames",
                                      "4_Road027_Trim005_frames"]
    assert lane_count(tmp / "pred") > 0


def test_test_vil_evaluate_equals_jax_metric(vil_run):
    """``--evaluate``: the JAX package's Python metric on the same files
    (the port's emission; the raster from the first annotation file's
    extent, as ``test_vil.py`` takes it)."""
    from phnet_tpu.evaluation import (aggregate_results, culane_metric,
                                      read_lines_txt)

    tmp, out = vil_run
    pred_dir, anno_dir = str(tmp / "pred"), str(tmp / "anno")
    shape, results = None, []
    for f in files(pred_dir):
        pred = read_lines_txt(os.path.join(pred_dir, f))
        anno = read_lines_txt(os.path.join(anno_dir, f))
        if shape is None:
            ys = [p[1] for lane in anno for p in lane] or [720]
            xs = [p[0] for lane in anno for p in lane] or [1280]
            shape = (int(max(ys)) + 1, int(max(xs)) + 1, 3)
        results.append(culane_metric(pred, anno, shape))
    assert out["metric"] == aggregate_results(results)


def test_test_vil_trains_first_on_the_dataset(tmp_path, capsys):
    """``--data-root`` with ``--train-first``: the overfit steps take the
    reader's first clip (its frames a tensor on the reader's device), then
    the run writes a line file a frame; ``--evaluate`` on a dataset gives
    no warning (the ground truth is written in the predictions' frame)."""
    out = t_test_vil.main(
        ["--data-root", FIXTURE, "--train-first", "1", "--chunk", str(CHUNK),
         "--pred-dir", str(tmp_path / "pred"), "--anno-dir",
         str(tmp_path / "anno"), "--evaluate", "--device", "cpu"],
        cfg=small_vil(tcfg))
    printed = capsys.readouterr()
    assert "overfit step 0: loss" in printed.out
    assert "not an accuracy" not in printed.err and not printed.err
    assert out["stats"]["frames"] == 8 and len(files(tmp_path / "pred")) == 8
    assert out["metric"] is not None


def run_main_capture(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(argv)
    return buf.getvalue(), ret


def test_evaluate_prints_jax_numbers(vil_run, monkeypatch):
    """``run.evaluate --native --temporal`` against the root ``evaluate.py``
    on the port's emission: the same printout (native numbers at IoU 0.5
    and 0.8, the Python metric, the temporal metric), but for the native
    mIoUs, which equal to 1e-12 of their value (OpenMP sums the frames'
    doubles in an order that changes from run to run, for either package,
    as ``test_torch_eval_metric.py`` holds them; the ground truth in the
    image's frame gives non-zero IoUs to sum)."""
    tmp, _ = vil_run
    argv = ["--pred-dir", str(tmp / "pred"), "--anno-dir", str(tmp / "anno"),
            "--height", "720", "--width", "1280", "--native", "--temporal"]
    if str(REPO) not in sys.path:
        monkeypatch.syspath_prepend(str(REPO))
    jax_evaluate = importlib.import_module("evaluate")
    monkeypatch.setattr(sys, "argv", ["evaluate.py"] + argv)
    want, _ = run_main_capture(lambda _: jax_evaluate.main(), None)
    got, ret = run_main_capture(t_evaluate.main, argv)
    assert "[native] IoU@0.5" in want and "temporal:" in want
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines)
    for g, w in zip(got_lines, want_lines):
        if not w.startswith("[native]"):
            assert g == w
            continue
        head = w.partition(": ")[0]
        assert g.startswith(head + ": ")
        gd, wd = (ast.literal_eval(x.partition(": ")[2]) for x in (g, w))
        assert gd.keys() == wd.keys()
        for key, value in wd.items():
            if key in ("miou", "miou_official"):
                assert gd[key] == pytest.approx(value, rel=1e-12, abs=0)
            else:
                assert gd[key] == value, key
    assert set(ret["native"]) == {0.5, 0.8}


def test_command_lines_default_to_the_card(tmp_path):
    """Without a card, every command line that runs the model raises
    unless given ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for main in (t_test_vil.main, t_test_ol.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--data-root", FIXTURE, "--pred-dir", str(tmp_path)],
                 cfg=None)
