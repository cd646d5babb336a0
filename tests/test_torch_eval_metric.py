"""The port's evaluation metrics against the JAX package's, on seeded
prediction / annotation pairs, on the CPU. Every comparison is exact:

* the Python CULane metric (``culane_metric``, ``culane_match``, the IoU
  matrix and the lane raster), whose lanes the port draws with its native
  replica of ``cv2.line`` and the JAX package with OpenCV;
* the native evaluator (``evaluate_pairs``, ``native_eval``) at IoU 0.5
  and 0.8, over files with missing predictions, empty files and lanes of
  one point: the counts, precision, recall and F1 exactly, the two mIoUs
  to 1e-12 of their value (OpenMP sums the frames' doubles in an order
  that changes from run to run, for either package);
* the temporal metric, the TuSimple accuracy and the datalist fixtures;
* ground truth scored against itself gives F1 = 1 in both metrics.
"""

import importlib
import os
import pickle

import numpy as np
import pytest

from phnet_torch.evaluation import fixtures as t_fix
from phnet_torch.evaluation import native_eval as t_native
from phnet_torch.evaluation import temporal as t_temporal
from phnet_torch.evaluation import tusimple_acc as t_acc
from phnet_torch.evaluation.emit import read_lines_txt
from phnet_tpu.evaluation import fixtures as j_fix
from phnet_tpu.evaluation import native_eval as j_native
from phnet_tpu.evaluation import temporal as j_temporal
from phnet_tpu.evaluation import tusimple_acc as j_acc

from torch_eval_parity import FIXTURE

t_metric = importlib.import_module("phnet_torch.evaluation.culane_metric")
j_metric = importlib.import_module("phnet_tpu.evaluation.culane_metric")

SHAPE = (720, 1280, 3)


def seeded_lane(rng, h=720, w=1280, inside=False):
    """A lane of 2-11 points, from below the image to its upper part, that
    may leave the canvas (``inside``: 3-11 points well inside it)."""
    n = int(rng.integers(3 if inside else 2, 12))
    if inside:
        y = np.sort(rng.uniform(0.4 * h, h - 20, n))[::-1]
        x = rng.uniform(0.3 * w, 0.7 * w) + rng.uniform(-0.4, 0.4) * (h - y)
    else:
        y = np.sort(rng.uniform(0.3 * h, h + 20, n))[::-1]
        x = rng.uniform(-50, w + 50) + rng.uniform(-1.5, 1.5) * (h - y)
    x = x + rng.normal(0, 3, n)
    return [(float(a), float(b)) for a, b in zip(np.round(x, 1),
                                                 np.round(y, 1))]


def seeded_frame(rng):
    """(pred, anno): 0-4 annotated lanes, predictions near two of them
    plus 0-3 strays."""
    anno = [seeded_lane(rng) for _ in range(int(rng.integers(0, 5)))]
    pred = [[(x + rng.normal(0, 8), y) for x, y in a] for a in anno[:2]]
    pred += [seeded_lane(rng) for _ in range(int(rng.integers(0, 4)))]
    return pred, anno


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return [seeded_frame(rng) for _ in range(24)]


def test_draw_lane_equals_opencv():
    rng = np.random.default_rng(1)
    for _ in range(20):
        lane = j_metric.interp_lane(seeded_lane(rng))
        for width in (30, 1, 7):
            np.testing.assert_array_equal(
                t_metric.draw_lane(lane, SHAPE, width),
                j_metric.draw_lane(lane, SHAPE, width))


def test_culane_metric_equals_jax(frames):
    n_tp = 0
    for pred, anno in frames:
        for thr in (0.5, 0.8):
            got = t_metric.culane_metric(pred, anno, SHAPE, 30, thr)
            want = j_metric.culane_metric(pred, anno, SHAPE, 30, thr)
            assert got[:3] == want[:3]
            np.testing.assert_array_equal(got[3], want[3])
            np.testing.assert_array_equal(got[4], want[4])
        n_tp += got[0]
        if pred and anno:
            np.testing.assert_array_equal(
                t_metric._iou_matrix(pred, anno, SHAPE, 30),
                j_metric._iou_matrix(pred, anno, SHAPE, 30))
        for g, w in zip(t_metric.culane_match(anno, pred, SHAPE),
                        j_metric.culane_match(anno, pred, SHAPE)):
            np.testing.assert_array_equal(g, w)
    assert n_tp > 0
    results = [t_metric.culane_metric(p, a, SHAPE) for p, a in frames]
    assert (t_metric.aggregate_results(results)
            == j_metric.aggregate_results(results))


def write_tree(root, frames, drop_every=5, one_point=True):
    """``<root>/{pred,anno}/<video>/<frame>.lines.txt`` of ``frames`` in
    three videos, with every ``drop_every``-th prediction file missing and
    (``one_point``) a lane of one point in some annotations; returns the
    file pairs."""
    pairs = []
    for k, (pred, anno) in enumerate(frames):
        vid, name = f"video_{k % 3}", f"{k:05d}.lines.txt"
        pf = os.path.join(root, "pred", vid, name)
        af = os.path.join(root, "anno", vid, name)
        os.makedirs(os.path.dirname(pf), exist_ok=True)
        os.makedirs(os.path.dirname(af), exist_ok=True)
        if k % drop_every:
            with open(pf, "w") as f:
                f.writelines(" ".join(f"{x:.1f} {y:.1f}" for x, y in lane)
                             + " \n" for lane in pred)
        with open(af, "w") as f:
            f.writelines(" ".join(f"{x:.1f} {y:.1f}" for x, y in lane)
                         + " \n" for lane in anno)
            if one_point and k % 4 == 1:
                f.write("640.0 700.0 \n")
        pairs.append((pf, af))
    return pairs


@pytest.fixture(scope="module")
def tree(frames, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lines"))
    return root, write_tree(root, frames)


def assert_native_equal(got, want):
    for key in ("TP", "FP", "FN", "Precision", "Recall", "F1"):
        assert got[key] == want[key], key
    for key in ("miou", "miou_official"):
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0), key


@pytest.mark.parametrize("thr", [0.5, 0.8])
def test_evaluate_pairs_equals_jax(tree, thr):
    root, pairs = tree
    got = t_native.evaluate_pairs(pairs, 1280, 720, 30, thr)
    assert_native_equal(got, j_native.evaluate_pairs(pairs, 1280, 720, 30,
                                                     thr))
    assert got["TP"] > 0 and got["FP"] > 0 and got["FN"] > 0
    dirs = (os.path.join(root, "pred"), os.path.join(root, "anno"))
    assert_native_equal(t_native.native_eval(*dirs, 1280, 720, 30, thr),
                        j_native.native_eval(*dirs, 1280, 720, 30, thr))


def test_ground_truth_against_itself_scores_one(tmp_path):
    rng = np.random.default_rng(2)
    frames = [([], [seeded_lane(rng, inside=True)
                    for _ in range(int(rng.integers(1, 5)))])
              for _ in range(6)]
    pairs = [(a, a) for _, a in write_tree(str(tmp_path), frames,
                                           one_point=False)]
    native = t_native.evaluate_pairs(pairs, 1280, 720)
    assert native["F1"] == 1.0 and native["FP"] == native["FN"] == 0
    assert native["TP"] == sum(len(a) for _, a in frames)
    results = [t_metric.culane_metric(read_lines_txt(a), read_lines_txt(a),
                                      SHAPE) for _, a in pairs]
    assert t_metric.aggregate_results(results)["F1"] == 1.0


def seeded_video(rng, t=6):
    """Frames of 2-4 lanes drifting a few pixels a frame, each lane
    predicted with noise that grows from frame to frame, one lane missed
    in some frames: stable, jittering and missed pairs."""
    lanes = [np.asarray(seeded_lane(rng, inside=True))
             for _ in range(int(rng.integers(2, 5)))]
    video = []
    for ti in range(t):
        anno = [[(x + 3 * ti, y) for x, y in lane] for lane in lanes]
        pred = [[(x + rng.normal(0, 4 * ti * (j + 1)), y) for x, y in a]
                for j, a in enumerate(anno) if (ti + j) % 3]
        video.append((pred, anno))
    return video


def test_temporal_equals_jax():
    rng = np.random.default_rng(3)
    videos = [seeded_video(rng) for _ in range(3)]
    got, want = [], []
    for video in videos:
        annos = [a for _, a in video]
        preds = [p for p, _ in video]
        shapes = [SHAPE] * len(video)
        for thr in (0.5, 0.8):
            g = t_temporal.temporal_metric_video(annos, preds, shapes, 30,
                                                 thr)
            w = j_temporal.temporal_metric_video(annos, preds, shapes, 30,
                                                 thr)
            assert g == w
        got.append(g)
        want.append(w)
    ns, nj, nm = map(sum, zip(*got))
    assert ns > 0 and nj > 0 and nm > 0
    assert (t_temporal.aggregate_temporal(got)
            == j_temporal.aggregate_temporal(want))


def test_tusimple_accuracy_equals_jax(frames):
    preds = [[np.asarray(p) for p in pred] for pred, _ in frames]
    annos = [[np.asarray(a) for a in anno] for _, anno in frames]
    assert (t_acc.evaluate_accuracy(preds, annos, 720)
            == j_acc.evaluate_accuracy(preds, annos, 720))


def test_datalists_equal_jax(tree, tmp_path):
    root, _ = tree
    vil = t_fix.enumerate_vil100(FIXTURE)
    assert vil == j_fix.enumerate_vil100(FIXTURE) and len(vil) == 8
    ol = t_fix.enumerate_openlane(FIXTURE)
    assert ol == j_fix.enumerate_openlane(FIXTURE) and len(ol) == 4
    assert (t_fix.read_shapes(FIXTURE, vil, "VIL100/JPEGImages")
            == j_fix.read_shapes(FIXTURE, vil, "VIL100/JPEGImages"))
    assert (t_fix.read_shapes(FIXTURE, ol, "OpenLane/images/validation")
            == j_fix.read_shapes(FIXTURE, ol, "OpenLane/images/validation"))
    shapes = t_fix.read_shapes(FIXTURE, vil, "VIL100/JPEGImages")
    got = t_fix.freeze(vil, str(tmp_path / "t"), "VIL", shapes)
    want = j_fix.freeze(vil, str(tmp_path / "j"), "VIL", shapes)
    for key in want:
        with open(got[key], "rb") as a, open(want[key], "rb") as b:
            assert a.read() == b.read(), key
    for path in (got["txt"], got["pickle"]):
        assert t_fix.load_datalist(path) == j_fix.load_datalist(path) == vil
    assert (t_fix.load_shape_list(got["shape_list"])
            == j_fix.load_shape_list(got["shape_list"]))
    # a reference-made pickle of numpy strings
    ref = tmp_path / "datalistOL.pickle"
    with open(ref, "wb") as f:
        pickle.dump(np.array(ol), f)
    assert t_fix.load_datalist(str(ref)) == j_fix.load_datalist(str(ref))
    anno_dir = os.path.join(root, "anno")
    entries = t_fix.datalist_from_anno_dir(anno_dir)
    assert entries == j_fix.datalist_from_anno_dir(anno_dir)
    assert (t_fix.pairs_from_datalist(entries, "p", anno_dir)
            == j_fix.pairs_from_datalist(entries, "p", anno_dir))
