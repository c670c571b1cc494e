"""The port's own copies of the host modules (``config``, ``io``, ``data``,
``data/distance.py``, ``train/images.py``) against the JAX package's: same
config values, same volumes read, same 3D and 2D transform outputs, the same
batches (with the attention networks' distance maps) and the same 2D slice
inventories and samples for the same seed and fixture case, the same
distance maps and the same logged images.
They are copies of one numpy/scipy code, so every comparison is exact. The
port keeps only the scipy resampler, so the JAX side is held to it too
(its optional native resampler agrees with scipy to rounding,
``tests/test_native.py``).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from fixtures import make_dataset_dir
from vnet_tpu import config as jconfig
from vnet_tpu import data as jdata
from vnet_tpu import io as jio
from vnet_tpu.data import distance as jdistance
from vnet_tpu.data import rand as jrand
from vnet_tpu.io import resample as jresample
from vnet_tpu.train import images as jimages
from vnet_tpu_torch import config as tconfig
from vnet_tpu_torch import data as tdata
from vnet_tpu_torch import io as tio
from vnet_tpu_torch.data import distance as tdistance
from vnet_tpu_torch.data import rand as trand
from vnet_tpu_torch.train import images as timages

PIPELINE = {"preprocess": {"train": {"3D": [
    {"name": "StatisticalNormalization", "variables": {"sigma": 2.5}},
    {"name": "Resample", "variables": {"voxel_size": [1.2, 1.1, 1.0]}},
    {"name": "Padding", "variables": {"output_size": [20, 20, 20]}},
    {"name": "ConfidenceCrop2",
     "variables": {"output_size": [16, 16, 16], "rand_range": 3,
                   "probability": 0.8}},
    {"name": "RandomFlip", "variables": {"axes": [True, False, True]}},
    {"name": "RandomNoise", "variables": {"sigma": 2}},
]}}}

# every registered 3D transform, with arguments
TRANSFORMS = {
    "Normalization": {}, "RandomFlip": {"axes": [True, True, False]},
    "StatisticalNormalization": {"sigma": 2.5},
    "ExtremumNormalization": {"percent": 0.05},
    "ManualNormalization": {"windowMin": 0, "windowMax": 200},
    "Reorient": {"order": [2, 0, 1]}, "Invert": {},
    "Resample": {"voxel_size": [0.9, 1.3, 2.0]},
    "Padding": {"output_size": [30, 20, 20]},
    "RandomCrop": {"output_size": [12, 12, 8], "drop_ratio": 0.5,
                   "min_pixel": 1},
    "RandomNoise": {"sigma": 3},
    "ConfidenceCrop": {"output_size": [12, 12, 8], "sigma": 2.5},
    "ConfidenceCrop2": {"output_size": [12, 12, 8], "rand_range": 3,
                        "probability": 0.5},
    "BSplineDeformation": {"randomness": 4},
}

# every registered 2D transform, with arguments
TRANSFORMS_2D = {
    "ManualNormalization": {"windowMin": 0, "windowMax": 200},
    "Resample": {"voxel_size": [0.8, 1.3]},
    "Padding": {"output_size": [30, 20]},
    "RandomCrop": {"output_size": [12, 12], "drop_ratio": 0.5,
                   "min_pixel": 1},
    "RandomFlip": {}, "RandomRotate": {},
    "RandomTranslate": {"maxOffset": [5, 5]}, "RadialDistortion": {},
}

PIPELINE_2D = {"preprocess": {"train": {
    "3D": [{"name": "StatisticalNormalization", "variables": {"sigma": 2.5}},
           {"name": "RandomNoise", "variables": {"sigma": 2}}],
    "2D": [{"name": "ManualNormalization",
            "variables": {"windowMin": 0, "windowMax": 600}},
           {"name": "Resample", "variables": {"voxel_size": [0.9, 0.9]}},
           {"name": "Padding", "variables": {"output_size": [20, 20]}},
           {"name": "RandomCrop", "variables": {"output_size": [16, 16]}},
           {"name": "RandomFlip"}]}}}


@pytest.fixture(autouse=True)
def _scipy_resampler(monkeypatch):
    monkeypatch.setattr(jresample, "_native_available", lambda: False)


@pytest.fixture
def dataset(tmp_path):
    split_dir, names, _ = make_dataset_dir(str(tmp_path), "training",
                                           num_cases=3,
                                           rng=np.random.default_rng(5))
    return split_dir, names


def test_config_values_equal(tmp_path):
    root = Path(__file__).resolve().parent.parent
    tree = json.loads((root / "configs" / "config.json").read_text())
    tree["TrainingSetting"]["Networks"].update(DropoutImpl="pallas",
                                               DwImpl="pallas")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(tree))
    j, t = jconfig.load_config(str(path)), tconfig.load_config(str(path))
    assert dataclasses.asdict(t.train) == dataclasses.asdict(j.train)
    assert dataclasses.asdict(t.evaluate) == dataclasses.asdict(j.evaluate)
    assert t.train.network.dw_impl == t.train.network.dropout_impl == "pallas"


def test_config_rejects_what_jax_rejects():
    tree = {"TrainingSetting": {"Networks": {"DwImpl": "cuda"}}}
    for mod in (jconfig, tconfig):
        with pytest.raises(mod.ConfigError, match="DwImpl"):
            mod.parse_config(tree)


def test_io_reads_and_resamples_alike(dataset, tmp_path):
    split_dir, names = dataset
    path = f"{split_dir}/{names[0]}/image.nii"
    j, t = jio.read_image(path), tio.read_image(path)
    np.testing.assert_array_equal(t.data, j.data)
    assert (t.spacing, t.origin, t.direction) == (j.spacing, j.origin,
                                                  j.direction)
    for interp in (tio.LINEAR, tio.NEAREST):
        rj = jio.resample_to_spacing(j, (0.7, 1.3, 1.1), interp)
        rt = tio.resample_to_spacing(t, (0.7, 1.3, 1.1), interp)
        np.testing.assert_array_equal(rt.data, rj.data)
    out = tmp_path / "round_trip.nii.gz"
    tio.write_image(t, str(out))
    np.testing.assert_array_equal(jio.read_image(str(out)).data, j.data)


def test_registries_equal():
    assert tdata.transform_names(3) == jdata.transform_names(3)
    assert sorted(TRANSFORMS) == tdata.transform_names(3)
    assert tdata.transform_names(2) == jdata.transform_names(2)
    assert sorted(TRANSFORMS_2D) == tdata.transform_names(2)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_outputs_equal(name, dataset):
    split_dir, names = dataset
    outs = []
    for data, rand in ((jdata, jrand), (tdata, trand)):
        ds = data.NiftiDataset3D(split_dir, train=True, labels=(0, 1))
        sample = ds.load_case(names[1])
        rand.seed(11)
        outs.append(data.build_transform(3, name, TRANSFORMS[name])(sample))
    (j, t) = outs
    np.testing.assert_array_equal(t["image"][0].data, j["image"][0].data)
    np.testing.assert_array_equal(t["label"].data, j["label"].data)
    assert t["image"][0].spacing == j["image"][0].spacing


def test_case_lists_and_batches_equal(dataset, tmp_path):
    split_dir, names = dataset
    assert tdata.list_cases(split_dir) == jdata.list_cases(split_dir) == names
    batches = []
    for data, rand in ((jdata, jrand), (tdata, trand)):
        rand.seed(3)
        transforms = data.build_pipeline(PIPELINE, "train", 3)
        ds = data.NiftiDataset3D(split_dir, transforms=transforms,
                                 train=True, labels=(0, 1))
        loader = data.BatchLoader(ds, 2, shuffle=True, num_workers=0,
                                  seed=9)
        batches.append([b for _ in range(2) for b in loader.epoch()])
    assert len(batches[0]) == len(batches[1]) == 2
    for (ji, jl), (ti, tl) in zip(*batches):
        assert ti.shape == (2, 16, 16, 16, 1) and tl.dtype == np.int32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("normalize", [True, False])
def test_distance_map_equal(normalize, rng):
    labels = [np.zeros((6, 5, 4), np.int32),
              (rng.random((12, 10, 8)) > 0.6).astype(np.int32),
              rng.integers(0, 3, (9, 9, 9)).astype(np.int32)]
    for label in labels:
        np.testing.assert_array_equal(
            tdistance.distance_map(label, normalize),
            jdistance.distance_map(label, normalize))


class _Recorder:
    def __init__(self):
        self.calls = []

    def add_image(self, tag, img, step, dataformats="HWC"):
        self.calls.append((tag, np.array(img), step, dataformats))


@pytest.mark.parametrize("shape", [(2, 6, 5, 4, 2), (3, 7, 6, 1)])
def test_logged_images_equal(shape, rng):
    """Every ``add_image`` call of ``log_batch_images``, 3D and 2D, and the
    colour map on its own."""
    images = rng.normal(100, 80, size=shape).astype(np.float32)
    spatial = shape[:-1]
    softmax = rng.random(spatial + (3,)).astype(np.float32)
    softmax /= softmax.sum(-1, keepdims=True)
    labels = rng.integers(0, 3, spatial).astype(np.int32)
    pred = np.argmax(softmax, -1)
    calls = []
    for mod in (jimages, timages):
        rec = _Recorder()
        mod.log_batch_images(rec, "train", images, labels, softmax, pred,
                             (0, 1, 4), 7)
        calls.append(rec.calls)
    assert len(calls[0]) == len(calls[1]) > 0
    for (jt, ja, js, jf), (tt, ta, ts, tf) in zip(*calls):
        assert (tt, ts, tf) == (jt, js, jf)
        assert ta.dtype == ja.dtype == np.uint8
        np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(timages.grayscale_to_rainbow(softmax),
                                  jimages.grayscale_to_rainbow(softmax))


def test_attention_samples_equal(dataset):
    """``attention=True`` adds the label's distance map as a third output."""
    split_dir, names = dataset
    samples = []
    for data, rand in ((jdata, jrand), (tdata, trand)):
        rand.seed(5)
        transforms = data.build_pipeline(PIPELINE, "train", 3)
        ds = data.NiftiDataset3D(split_dir, transforms=transforms,
                                 train=True, labels=(0, 1), attention=True)
        samples.append(ds.get_sample(0))
    (j, t) = samples
    assert len(t) == len(j) == 3
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t[2], tdistance.distance_map(t[1]))


def _oblique(data):
    """``MedicalImage`` kwargs of a volume with an off-axis geometry."""
    c, s = np.cos(0.3), np.sin(0.3)
    return dict(spacing=(0.8, 1.1, 1.7), origin=(-12.0, 30.5, 4.25),
                direction=(c, -s, 0.0, s, c, 0.0, 0.0, 0.0, 1.0))


def test_extract_slice_equal(rng):
    data = rng.normal(size=(7, 6, 5)).astype(np.float32)
    for z in (0, 3, 4):
        j = jdata.dataset2d.extract_slice(
            jio.MedicalImage(data, **_oblique(data)), z)
        t = tdata.dataset2d.extract_slice(
            tio.MedicalImage(data, **_oblique(data)), z)
        np.testing.assert_array_equal(t.data, j.data)
        assert (t.spacing, t.origin, t.direction) == (j.spacing, j.origin,
                                                      j.direction)


@pytest.mark.parametrize("name", sorted(TRANSFORMS_2D))
def test_transform_2d_outputs_equal(name, dataset):
    split_dir, names = dataset
    outs = []
    for data, rand in ((jdata, jrand), (tdata, trand)):
        case = data.NiftiDataset3D(split_dir, train=True,
                                   labels=(0, 1)).load_case(names[1])
        sample = {"image": [data.dataset2d.extract_slice(im, 8)
                            for im in case["image"]],
                  "label": data.dataset2d.extract_slice(case["label"], 8)}
        rand.seed(11)
        outs.append(data.build_transform(2, name, TRANSFORMS_2D[name])(sample))
    (j, t) = outs
    np.testing.assert_array_equal(t["image"][0].data, j["image"][0].data)
    np.testing.assert_array_equal(t["label"].data, j["label"].data)
    assert (t["image"][0].spacing, t["image"][0].origin) == (
        j["image"][0].spacing, j["image"][0].origin)


@pytest.mark.parametrize("cache_cases", [0, 3])
def test_slice_inventory_and_batches_equal(cache_cases, dataset):
    """``NiftiDataset2D``'s inventory (``MinPixel`` / ``DropRatio`` from the
    shared generator) and its batches through the loader."""
    split_dir, _ = dataset
    runs = []
    for data, rand in ((jdata, jrand), (tdata, trand)):
        rand.seed(4)
        transforms = data.build_pipeline(PIPELINE_2D, "train", 2)
        ds = data.NiftiDataset2D(
            split_dir, transforms3D=transforms["3D"],
            transforms2D=transforms["2D"], train=True, labels=(0, 1),
            min_pixel=30, drop_ratio=0.3, cache_cases=cache_cases)
        loader = data.BatchLoader(ds, 3, shuffle=True, num_workers=0,
                                  seed=9)
        runs.append((ds.slices, [b for _ in range(2)
                                 for b in loader.epoch()]))
    (j_slices, j_batches), (t_slices, t_batches) = runs
    assert t_slices == j_slices and len(t_slices) >= 6
    assert len(t_batches) == len(j_batches) >= 2
    for (ji, jl), (ti, tl) in zip(j_batches, t_batches):
        assert ti.shape == (3, 16, 16, 1) and tl.dtype == np.int32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
