"""The port's own copies of the host modules (``config``, ``io``, ``data``)
against the JAX package's: same config values, same volumes read, same
transform outputs and the same batches for the same seed and fixture case.
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
from vnet_tpu.data import rand as jrand
from vnet_tpu.io import resample as jresample
from vnet_tpu_torch import config as tconfig
from vnet_tpu_torch import data as tdata
from vnet_tpu_torch import io as tio
from vnet_tpu_torch.data import rand as trand

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
