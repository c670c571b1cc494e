"""The port's host utilities (``vnet_tpu_torch/utils``) against the JAX
package's (``vnet_tpu/utils``): the synthetic-data generator draws the same
arrays and writes the same NIfTI bytes from the same seed, and the scoring,
bounding-box and dataset-preparation functions give equal outputs on the
inputs of ``tests/test_utils.py`` and ``tests/test_batch_evaluate.py``.
They are copies of one numpy/scipy code, so every comparison is exact. The
command lines (``python -m vnet_tpu_torch.utils.{batch_evaluate,bbox,
prepare_data}``) run on the CPU against the JAX package's functions.
"""

import dataclasses
import os
import zipfile

import numpy as np
import pytest

from vnet_tpu import io as jio
from vnet_tpu.config import parse_config as jparse
from vnet_tpu.utils import batch_evaluate as jbe
from vnet_tpu.utils import bbox as jbbox
from vnet_tpu.utils import prepare_data as jprep
from vnet_tpu.utils import synthdata as jsynth
from vnet_tpu_torch import io as tio
from vnet_tpu_torch.config import parse_config as tparse
from vnet_tpu_torch.utils import batch_evaluate as tbe
from vnet_tpu_torch.utils import bbox as tbbox
from vnet_tpu_torch.utils import prepare_data as tprep
from vnet_tpu_torch.utils import synthdata as tsynth
from vnet_tpu_torch.utils.bbox import main as bbox_main
from vnet_tpu_torch.utils.prepare_data.__main__ import main as prep_main


def _images(io, arrays, spacing=(1.0, 1.0, 1.0), origin=None):
    return [io.MedicalImage(a, spacing, origin) if origin is not None
            else io.MedicalImage(a, spacing) for a in arrays]


def _same_image(a, b):
    assert a.data.dtype == b.data.dtype
    np.testing.assert_array_equal(a.data, b.data)
    assert tuple(a.spacing) == tuple(b.spacing)
    assert tuple(a.origin) == tuple(b.origin)
    assert tuple(a.direction) == tuple(b.direction)


def blob(positions, shape=(24, 24, 24), radius=2):
    data = np.zeros(shape, np.uint8)
    for p in positions:
        data[tuple(slice(max(c - radius, 0), c + radius) for c in p)] = 1
    return data


# --- synthdata -------------------------------------------------------------

@pytest.mark.parametrize("multimodal", [False, True])
@pytest.mark.parametrize("seed,shape", [(1337, (48, 48, 32)),
                                        (7, (40, 36, 28))])
def test_synthdata_cases_equal_jax(seed, shape, multimodal):
    make = "make_hard_case_multimodal" if multimodal else "make_hard_case"
    j_img, j_lbl = getattr(jsynth, make)(np.random.default_rng(seed),
                                         shape=shape)
    t_img, t_lbl = getattr(tsynth, make)(np.random.default_rng(seed),
                                         shape=shape)
    j_img = j_img if multimodal else [j_img]
    t_img = t_img if multimodal else [t_img]
    assert len(t_img) == len(j_img)
    for a, b in zip(t_img + [t_lbl], j_img + [j_lbl]):
        _same_image(a, b)
    assert (t_lbl.data > 0).any()


@pytest.mark.parametrize("multimodal", [False, True])
@pytest.mark.parametrize("shape", [(32, 32, 24), (28, 36, 20)])
def test_synthdata_dataset_bytes_equal_jax(tmp_path, shape, multimodal):
    """Two cases from one generator: the same files, byte for byte."""
    roots = {}
    for name, mod in (("jax", jsynth), ("port", tsynth)):
        roots[name] = str(tmp_path / name)
        mod.make_hard_dataset(roots[name], "training", 2,
                              np.random.default_rng(3), shape=shape,
                              multimodal=multimodal, contrast=2.0)
    files = ["image.nii", "label.nii"] + (["image_t2.nii"] if multimodal
                                          else [])
    for case in ("case_0", "case_1"):
        for f in files:
            paths = [os.path.join(roots[n], "training", case, f)
                     for n in ("jax", "port")]
            with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
                assert a.read() == b.read(), (case, f)
    assert sorted(os.listdir(os.path.join(roots["port"], "training",
                                          "case_0"))) == sorted(files)


def test_dice_per_class_equal_jax():
    rng = np.random.default_rng(0)
    pred = rng.integers(0, 3, size=(16, 16, 8))
    truth = rng.integers(0, 3, size=(16, 16, 8))
    truth[truth == 2] = 0  # a class absent from the truth
    for p, t, n in ((pred, truth, 3), (pred, truth, 4),
                    (np.zeros((4, 4)), np.zeros((4, 4)), 2)):
        assert tsynth.dice_per_class(p, t, n) == jsynth.dice_per_class(
            p, t, n)


# --- batch_evaluate ----------------------------------------------------------

PAIRS = {
    "perfect": (blob([(10, 10, 10)]), blob([(10, 10, 10)])),
    "partial": (blob([(10, 10, 10)], radius=3), blob([(11, 10, 10)],
                                                     radius=3)),
    "tp_fp_fn": (blob([(6, 6, 12), (18, 18, 12)], radius=3),
                 blob([(6, 6, 12), (12, 18, 12)], radius=3)),
    "no_gt": (blob([]), blob([(6, 6, 12)], radius=3)),
    "empty": (blob([]), blob([])),
}


def _thin():
    out = np.zeros((24, 24, 24), np.uint8)
    out[10:16, 10:16, 12] = 1  # one slice thick: extent-filtered
    return blob([(12, 12, 12)], radius=3), out


def _buckets():
    gt = np.zeros((24, 24, 24), np.uint8)
    gt[0:2, 0, 0] = 1
    gt[4:7, 4:7, 4:7] = 1
    gt[12:17, 12:17, 12:17] = 1
    out = np.zeros_like(gt)
    out[18:23, 18:23, 0:5] = 1
    out[0:2, 0:2, 0:6] = 1
    out[8:13, 8:13, 10:17] = 1
    return gt, out


PAIRS["thin"] = _thin()
PAIRS["buckets"] = _buckets()


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (2.0, 2.0, 2.0),
                                     (0.8, 0.7, 1.5)])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_scores_equal_jax(pair, spacing):
    gt, out = PAIRS[pair]
    got, want = {}, {}
    for res, mod, io in ((got, tbe, tio), (want, jbe, jio)):
        g, o = _images(io, [gt, out], spacing)
        res["overlap"] = mod.overlap_measures(g, o)
        for tol, thick in ((3.0, 3), (3.0, 6), (1.0, 3)):
            res[("det", tol, thick)] = mod.lesion_detection(
                g, o, tolerance=tol, thickness_threshold=thick)
        res["buckets"] = mod.lesion_volume_buckets(g, o)
        res["buckets3"] = mod.lesion_volume_buckets(g, o,
                                                    thickness_threshold=3)
    assert got == want


def _eval_dir(root):
    for i, shift in enumerate([0, 1]):
        case = os.path.join(root, f"case_{i}")
        os.makedirs(case)
        gt = np.zeros((16, 16, 16), np.uint8)
        gt[4:12, 4:12, 4:12] = 1
        pred = np.zeros_like(gt)
        pred[4 + shift:12 + shift, 4:12, 4:12] = 1
        jio.write_image(jio.MedicalImage(gt), os.path.join(case, "label.nii"))
        jio.write_image(jio.MedicalImage(pred),
                        os.path.join(case, "label_out.nii.gz"))
    return root


def _tree(eval_dir):
    return {
        "TrainingSetting": {
            "Data": {"TrainingDataDirectory": "", "TestingDataDirectory": "",
                     "ImageFilenames": ["image.nii"],
                     "LabelFilename": "label.nii"},
            "PatchShape": [8, 8, 8], "Networks": {}},
        "EvaluationSetting": {
            "Data": {"EvaluateDataDirectory": eval_dir,
                     "LabelFilename": "label_out.nii.gz"},
            "Stride": [8, 8, 8]},
    }


@pytest.mark.parametrize("modes", [("DICE",), ("DICE", "ITEM"),
                                   ("DICE", "VOLUME"), ("ITEM", "VOLUME")])
def test_score_case_equal_jax(tmp_path, modes):
    eval_dir = _eval_dir(str(tmp_path / "evaluate"))
    be_t = tbe.BatchEvaluate(tparse(_tree(eval_dir)), modes=modes,
                             device="cpu")
    be_j = jbe.BatchEvaluate(jparse(_tree(eval_dir)), modes=modes)
    for case in ("case_0", "case_1", "missing"):
        path = os.path.join(eval_dir, case)
        assert be_t.score_case(path, "label_out.nii.gz") == be_j.score_case(
            path, "label_out.nii.gz")
    assert be_t.checkpoints == be_j.checkpoints


def test_grid_result_csv_and_best_equal_jax(tmp_path):
    grids = {}
    for name, mod, parse in (("port", tbe, tparse), ("jax", jbe, jparse)):
        r1 = mod.GridResult("ckpt_a", 8, 8, {"case_0": {"DICE": 0.9},
                                             "case_1": {"DICE": 0.7,
                                                        "TP": 1}})
        r2 = mod.GridResult("ckpt_b", 16, 4, {"case_0": {"DICE": 0.95}})
        be = mod.BatchEvaluate(parse(_tree(str(tmp_path))))
        path = str(tmp_path / name / "grid.csv")
        be.write_csv([r1, r2], path)
        grids[name] = (open(path).read(), r1.mean("DICE"), r1.mean("TP"),
                       r2.mean("TP"), mod.BatchEvaluate.best([r1, r2]).checkpoint)
    assert grids["port"][0] == grids["jax"][0]
    np.testing.assert_equal(grids["port"][1:], grids["jax"][1:])
    assert grids["port"][-1] == "ckpt_b"


# --- bbox ------------------------------------------------------------------

def _slice_two_boxes():
    sl = np.zeros((20, 20), np.uint8)
    sl[2:6, 2:6] = 1
    sl[10:18, 10:18] = 1
    sl[3:9, 12:15] = 2
    return sl


@pytest.mark.parametrize("iou", [0.0, 0.5, 1.0])
def test_slice_boxes_and_nms_equal_jax(iou):
    sl = _slice_two_boxes()
    for cls in (0, 1, 2, 3):
        t = tbbox.slice_boxes(sl, cls)
        j = jbbox.slice_boxes(sl, cls)
        assert [dataclasses.astuple(b) for b in t] == [
            dataclasses.astuple(b) for b in j]
    boxes_t = tbbox.slice_boxes(sl, 1) + tbbox.slice_boxes(sl, 2)
    boxes_j = jbbox.slice_boxes(sl, 1) + jbbox.slice_boxes(sl, 2)
    kept_t = tbbox.nms(boxes_t + boxes_t, iou)
    kept_j = jbbox.nms(boxes_j + boxes_j, iou)
    assert [dataclasses.astuple(b) for b in kept_t] == [
        dataclasses.astuple(b) for b in kept_j]
    assert [b.iou(c) for b in boxes_t for c in boxes_t] == [
        b.iou(c) for b in boxes_j for c in boxes_j]


@pytest.mark.parametrize("classes", [[0, 1], [1, 2], [2]])
def test_volume_boxes_equal_jax(classes):
    data = blob([(10, 10, 5), (3, 18, 9)], radius=3)
    data[15:20, 2:6, 4:8] = 2
    got = tbbox.volume_boxes(tio.MedicalImage(data), classes)
    want = jbbox.volume_boxes(jio.MedicalImage(data), classes)
    assert {z: [dataclasses.astuple(b) for b in bs]
            for z, bs in got.items()} == {
        z: [dataclasses.astuple(b) for b in bs] for z, bs in want.items()}


def test_bbox_main_renders_the_boxed_slices(tmp_path):
    pytest.importorskip("matplotlib")
    data = blob([(10, 10, 5)], radius=3)
    tio.write_image(tio.MedicalImage(data.astype(np.float32)),
                    str(tmp_path / "image.nii"))
    tio.write_image(tio.MedicalImage(data), str(tmp_path / "label.nii"))
    out = tmp_path / "out"
    boxes = bbox_main(["--image", str(tmp_path / "image.nii"),
                       "--label", str(tmp_path / "label.nii"),
                       "--classes", "1", "--out_dir", str(out)])
    assert sorted(os.listdir(out)) == [f"slice_{z:04d}.png"
                                       for z in sorted(boxes)]
    assert sorted(boxes) == sorted(jbbox.volume_boxes(
        jio.MedicalImage(data), [1]))


# --- prepare_data ------------------------------------------------------------

def _label_10():
    lbl = np.zeros((10, 10, 10), np.uint8)
    lbl[2:5] = 1
    lbl[6:8] = 2
    return lbl


@pytest.mark.parametrize("select,mask,dilation", [
    ([2], [1, 2], 1), ([1, 2], [], 5), ([1], [2], 0), ([3], [1], 2)])
def test_binarize_labels_equal_jax(select, mask, dilation):
    lbl = _label_10()
    img = np.random.default_rng(1).normal(7, 1, (10, 10, 10)).astype(
        np.float32)
    outs = []
    for prep, io in ((tprep, tio), (jprep, jio)):
        l, i = _images(io, [lbl, img], (1.0, 2.0, 1.5), (1.0, 2.0, 3.0))
        outs.append(prep.binarize_labels(l, select, i, mask, dilation))
    (tl, ti), (jl, ji) = outs
    _same_image(tl, jl)
    assert (ti is None) == (ji is None)
    if ti is not None:
        _same_image(ti, ji)


def test_unify_header_equal_jax():
    outs = []
    for prep, io in ((tprep, tio), (jprep, jio)):
        img = io.MedicalImage(np.zeros((4, 4, 4), np.float32), (2., 2., 2.),
                              (1., 2., 3.))
        lbl = io.MedicalImage(np.ones((4, 4, 4), np.uint8))
        outs.append(prep.unify_header(img, lbl))
    _same_image(*outs)


@pytest.mark.parametrize("depth,layers", [(150, 64), (64, 64), (10, 3)])
def test_partition_z_equal_jax(depth, layers):
    rng = np.random.default_rng(depth)
    img = rng.normal(size=(8, 6, depth)).astype(np.float32)
    lbl = (img > 1).astype(np.uint8)
    parts = []
    for prep, io in ((tprep, tio), (jprep, jio)):
        i, l = _images(io, [img, lbl], (0.5, 0.7, 1.25), (3., -2., 1.))
        parts.append(prep.partition_z(i, l, layers))
    assert [p[0] for p in parts[0]] == [p[0] for p in parts[1]]
    for (_, ti, tl), (_, ji, jl) in zip(*parts):
        _same_image(ti, ji)
        _same_image(tl, jl)


@pytest.mark.parametrize("box,dilation", [
    ((slice(8, 12),) * 3, 2), ((slice(0, 3), slice(5, 19), slice(17, 20)), 5),
    (None, 5)])
def test_fit_label_crop_equal_jax(box, dilation):
    img = np.random.default_rng(0).normal(size=(20, 20, 20)).astype(
        np.float32)
    lbl = np.zeros((20, 20, 20), np.uint8)
    if box is not None:
        lbl[box] = 1
    outs = []
    for prep, io in ((tprep, tio), (jprep, jio)):
        i, l = _images(io, [img, lbl], (1.0, 0.5, 2.0), (1., 1., 1.))
        outs.append(prep.fit_label_crop(i, l, dilation))
    for a, b in zip(*outs):
        _same_image(a, b)


def _flat_lits(root):
    os.makedirs(root)
    img = jio.MedicalImage(np.zeros((4, 4, 4), np.float32))
    for name in ("volume-3.nii", "segmentation-3.nii", "volume-12.nii.gz",
                 "segmentation-12.nii.gz", "notes.txt"):
        if name.endswith(".txt"):
            open(os.path.join(root, name), "w").close()
        else:
            jio.write_image(img, os.path.join(root, name))


def _tree_of(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_lits_restructure_and_unzip_equal_jax(tmp_path):
    for name, prep in (("port", tprep), ("jax", jprep)):
        base = tmp_path / name
        _flat_lits(str(base / "flat"))
        moved = prep.lits_restructure(str(base / "flat"), str(base / "cases"))
        assert [os.path.relpath(m, base) for m in moved] == [
            os.path.join("cases", c, f) for c, f in (
                ("12", "label.nii.gz"), ("3", "label.nii"),
                ("12", "image.nii.gz"), ("3", "image.nii"))]
        os.makedirs(base / "zips")
        with zipfile.ZipFile(base / "zips" / "case_a.zip", "w") as zf:
            zf.writestr("orig/struct.nii.gz", b"abc")
            zf.writestr("pre/FLAIR.nii.gz", b"de")
        out = prep.unzip_adam(str(base / "zips"), str(base / "adam"))
        assert [os.path.relpath(o, base) for o in out] == [
            os.path.join("adam", "case_a")]
    for sub in ("flat", "cases", "adam"):
        assert _tree_of(tmp_path / "port" / sub) == _tree_of(
            tmp_path / "jax" / sub)


def _cases(root):
    rng = np.random.default_rng(5)
    for case, spacing in (("c1", (1., 1., 1.)), ("c2", (2., 2., 2.))):
        cdir = os.path.join(root, case)
        os.makedirs(cdir)
        img = rng.normal(size=(12, 12, 20)).astype(np.float32)
        lbl = np.zeros((12, 12, 20), np.uint8)
        lbl[3:6, 4:9, 5:12] = 1
        lbl[7:9, 7:9, 14:16] = 2
        jio.write_image(jio.MedicalImage(img), os.path.join(cdir, "image.nii"))
        jio.write_image(jio.MedicalImage(lbl, spacing),
                        os.path.join(cdir, "label.nii"))


def test_check_header_consistency_equal_jax(tmp_path):
    _cases(str(tmp_path / "data"))
    got = tprep.check_header_consistency(str(tmp_path / "data"))
    assert got == jprep.check_header_consistency(str(tmp_path / "data"))
    assert got == {"c2": ["spacing"]}


@pytest.mark.parametrize("argv", [
    ["check"], ["partition", "--layers", "8"],
    ["binarize", "--select", "2", "--mask", "1", "2", "--dilation", "1"],
    ["binarize", "--select", "1"], ["fit_label", "--dilation", "2"]])
def test_prepare_data_main_writes_jax_outputs(tmp_path, argv, capsys):
    """The command line writes what the JAX package's functions compute."""
    data = str(tmp_path / "data")
    _cases(data)
    cmd, rest = argv[0], argv[1:]
    extra = ["--tgt", str(tmp_path / "chunks")] if cmd == "partition" else []
    prep_main([cmd, "--data", data] + extra + rest)
    out = capsys.readouterr().out
    for case in ("c1", "c2"):
        cdir = os.path.join(data, case)
        img = jio.read_image(os.path.join(cdir, "image.nii"))
        lbl = jio.read_image(os.path.join(cdir, "label.nii"))
        if cmd == "check":
            assert out.splitlines()[-1] == "1 inconsistent case(s)"
        elif cmd == "partition":
            for z, ic, lc in jprep.partition_z(img, lbl, 8):
                chunk = str(tmp_path / "chunks" / f"{case}_{z}")
                _same_image(tio.read_image(os.path.join(chunk,
                                                        "image.nii.gz")), ic)
                _same_image(tio.read_image(os.path.join(chunk,
                                                        "label.nii.gz")), lc)
        elif cmd == "binarize":
            select = [int(rest[1])]
            mask = [1, 2] if "--mask" in rest else []
            want_l, want_i = jprep.binarize_labels(
                lbl, select, img if mask else None, mask,
                1 if mask else 5)
            _same_image(tio.read_image(os.path.join(
                cdir, "label_masked.nii.gz")), want_l)
            assert os.path.exists(os.path.join(
                cdir, "image_masked.nii.gz")) == bool(mask)
            if mask:
                _same_image(tio.read_image(os.path.join(
                    cdir, "image_masked.nii.gz")), want_i)
        else:
            want_i, want_l = jprep.fit_label_crop(img, lbl, 2)
            _same_image(tio.read_image(os.path.join(
                cdir, "image_cropped.nii.gz")), want_i)
            _same_image(tio.read_image(os.path.join(
                cdir, "label_cropped.nii.gz")), want_l)
