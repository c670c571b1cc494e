"""The port's native runtime (``vnet_tpu_torch/native.py`` and
``vnet_tpu_torch/csrc/native/``) against the JAX package's, on the CPU.

* The copied C++ sources equal ``csrc/``'s byte for byte.
* The five host-op bindings equal the expectations of JAX's
  ``tests/test_native.py`` (scipy and numpy), and ``vnet_tpu.native``
  where that library is built (this file never builds it: JAX's test
  builds it with cmake into ``csrc/build``).
* The C++ test binary passes: the PJRT-free cases of ``csrc/native_test.cc``
  and the libtorch executor on a tiny CPU AOTInductor package from
  converted JAX weights, against JAX's exported forward (1e-5) and
  chunked (``AsExecutor(2)`` on 5 patches) against single runs.
* ``vnet_infer_torch`` segments the bright cube with its threshold
  executor, and with the package its label on a 24^3 volume equals a
  Python pass over the same steps in ``csrc/inference_client.cc``'s order
  (``vnet_tpu.native``'s host ops where built, else the scipy and numpy
  functions they are held to, and JAX's exported forward); labels may
  differ only where the two highest JAX probabilities lie within 1e-4.

The build runs once per file, in three processes at once into a private
directory: exactly one compiles and all three get its targets.
"""

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from vnet_tpu import native as jnative
from vnet_tpu.data.transforms3d import _window
from vnet_tpu.export import export_forward as jax_export_forward
from vnet_tpu.export import load_exported as jax_load_exported
from vnet_tpu.infer import build_patch_grid
from vnet_tpu.models import build_network as jax_build_network
from vnet_tpu_torch import export, native
from vnet_tpu_torch.convert import flax_to_state_dict
from vnet_tpu_torch.io import MedicalImage, read_image, write_image
from vnet_tpu_torch.models import build_network

from torch_parity import random_variables

ROOT = Path(__file__).resolve().parent.parent
COPIES = ("thread_pool.h", "safe_queue.h", "host_ops.cc", "nifti_io.h",
          "nifti_io.cc", "inference_client.h", "inference_client.cc")
BUILD_IN = ("import sys\n"
            "from pathlib import Path\n"
            "import vnet_tpu_torch.native as n\n"
            "n.build_dir = lambda: Path(sys.argv[1])\n"
            "b = n.build()\n"
            "print(b.compiled, b.directory)\n")
PACKAGE_SHAPE = (2, 16, 16, 16, 1)
TIE = 1e-4


@pytest.mark.parametrize("name", COPIES)
def test_copy_equals_the_original(name):
    assert ((ROOT / "vnet_tpu_torch" / "csrc" / "native" / name).read_bytes()
            == (ROOT / "csrc" / name).read_bytes())


@pytest.mark.parametrize("name", sorted(
    p.name for p in (ROOT / "vnet_tpu_torch" / "csrc" / "native").iterdir()))
def test_source_includes_no_file_of_the_jax_package(name):
    """Quoted includes name files beside it; nothing reaches ``csrc/``."""
    native_dir = ROOT / "vnet_tpu_torch" / "csrc" / "native"
    text = (native_dir / name).read_text()
    for header in re.findall(r'^#include\s+"([^"]+)"', text, re.MULTILINE):
        assert (native_dir / header).is_file(), (name, header)


def _build_concurrently(directory: Path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_IN,
                               str(directory)], cwd=str(ROOT), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    return [out.split() for out, _ in outs]


@pytest.fixture(scope="module")
def runtime(tmp_path_factory):
    """The native targets, built in three processes at once into a
    private directory (bound in this process too), and a tiny CPU package
    of a JAX-initialised VNet with JAX's probabilities on one input."""
    tmp = tmp_path_factory.mktemp("native")
    with ThreadPoolExecutor(1) as pool:
        builds = pool.submit(_build_concurrently, tmp / "build")
        jnet = jax_build_network("VNet", num_classes=2, num_channels=4,
                                 num_levels=1, num_convolutions=(1,),
                                 bottom_convolutions=1, dropout_rate=0.0)
        variables = random_variables(jnet, np.random.default_rng(11),
                                     jnp.zeros(PACKAGE_SHAPE), train=False)
        net = build_network("VNet", num_classes=2, num_channels=4,
                            num_levels=1, num_convolutions=(1,),
                            bottom_convolutions=1, dropout_rate=0.0,
                            device="cpu")
        net.load_state_dict(flax_to_state_dict(variables))
        package = export.export_package(net, PACKAGE_SHAPE,
                                        str(tmp / "tiny.pt2"), device="cpu")
        forward = jax_load_exported(jax_export_forward(jnet, variables,
                                                       PACKAGE_SHAPE))
        x = np.random.default_rng(12).normal(size=PACKAGE_SHAPE).astype(
            np.float32)
        x.tofile(tmp / "input.f32")
        np.asarray(forward(x), np.float32).tofile(tmp / "expected.f32")
        reports = builds.result()
    patch = pytest.MonkeyPatch()
    patch.setattr(native, "build_dir", lambda: tmp / "build")
    native.build.cache_clear()
    native._lib.cache_clear()
    try:
        yield dict(tmp=tmp, reports=reports, build=native.build(),
                   package=package, forward=forward)
    finally:
        patch.undo()
        native.build.cache_clear()
        native._lib.cache_clear()


def test_concurrent_builds_share_one(runtime):
    reports = runtime["reports"]
    assert sorted(compiled for compiled, _ in reports) == [
        "False", "False", "True"]
    assert len({directory for _, directory in reports}) == 1
    build = runtime["build"]
    assert not build.compiled and str(build.directory) == reports[0][1]
    assert [p.name for p in build.directory.parent.iterdir()
            if p.name.endswith(".tmp")] == []
    assert native.available()
    for target in (build.host_library, build.infer, build.test):
        assert target.is_file()


def _jax_native():
    return jnative if jnative.available() else None


def test_window_normalize(runtime, rng):
    x = rng.normal(100, 200, size=(8, 8, 8)).astype(np.float32)
    got = native.window_normalize(x, 0.0, 600.0)
    np.testing.assert_allclose(got, _window(x, 0.0, 600.0), atol=1e-3)
    if _jax_native():
        np.testing.assert_array_equal(
            got, jnative.window_normalize(x, 0.0, 600.0))


def test_patch_grid(runtime):
    got = native.patch_grid((10, 8, 8), (4, 4, 4), (4, 4, 4))
    np.testing.assert_array_equal(
        got, build_patch_grid((10, 8, 8), (4, 4, 4), (4, 4, 4)))
    if _jax_native():
        np.testing.assert_array_equal(
            got, jnative.patch_grid((10, 8, 8), (4, 4, 4), (4, 4, 4)))


@pytest.mark.parametrize("nearest", [False, True])
def test_resample3d(runtime, rng, nearest):
    x = rng.normal(size=(9, 9, 9)).astype(np.float32)
    M = np.diag([1.5, 1.5, 1.5])
    offset = np.array([0.25, 0.0, -0.5])
    got = native.resample3d(x, (6, 6, 6), M, offset, nearest=nearest)
    # these offsets avoid nearest ties at exact .5 boundaries
    expected = ndimage.affine_transform(
        x, M, offset, output_shape=(6, 6, 6), order=0 if nearest else 1,
        mode="constant", cval=0.0, prefilter=False)
    np.testing.assert_allclose(got, expected, atol=1e-5 if nearest else 1e-4)
    if _jax_native():
        np.testing.assert_array_equal(
            got, jnative.resample3d(x, (6, 6, 6), M, offset, nearest=nearest))


def test_extract_and_blend(runtime, rng):
    vol = rng.normal(size=(8, 8, 8, 1)).astype(np.float32)
    starts = np.array([[0, 0, 0], [4, 4, 4], [2, 2, 2]], np.int64)
    patches = native.extract_patches(vol, (4, 4, 4), starts)
    assert patches.shape == (3, 4, 4, 4, 1)
    for i, s in enumerate(starts):
        sl = tuple(slice(int(a), int(a) + 4) for a in s)
        np.testing.assert_array_equal(patches[i], vol[sl])

    acc = np.zeros((8, 8, 8, 2), np.float32)
    weight = np.zeros((8, 8, 8), np.float32)
    probs = rng.random((3, 4, 4, 4, 2)).astype(np.float32)
    window = rng.random((4, 4, 4)).astype(np.float32)
    native.blend_accumulate(acc, weight, probs, window, starts)
    exp_acc, exp_w = np.zeros_like(acc), np.zeros_like(weight)
    for i, s in enumerate(starts):
        sl = tuple(slice(int(a), int(a) + 4) for a in s)
        exp_acc[sl] += probs[i] * window[..., None]
        exp_w[sl] += window
    np.testing.assert_allclose(acc, exp_acc, rtol=1e-5)
    np.testing.assert_allclose(weight, exp_w, rtol=1e-5)
    if _jax_native():
        np.testing.assert_array_equal(
            patches, jnative.extract_patches(vol, (4, 4, 4), starts))
        ref_acc, ref_w = np.zeros_like(acc), np.zeros_like(weight)
        jnative.blend_accumulate(ref_acc, ref_w, probs, window, starts)
        np.testing.assert_array_equal(acc, ref_acc)
        np.testing.assert_array_equal(weight, ref_w)
    with pytest.raises(ValueError, match="leaves the volume"):
        native.extract_patches(vol, (4, 4, 4), np.array([[6, 0, 0]]))


def test_cpp_tests_pass(runtime):
    tmp = runtime["tmp"]
    proc = subprocess.run(
        [str(runtime["build"].test), str(tmp), runtime["package"],
         str(tmp / "input.f32"), str(tmp / "expected.f32")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all native tests passed" in proc.stdout
    assert "AsExecutor(2) on 5 patches" in proc.stdout


def test_threshold_cli_segments_the_bright_cube(runtime, tmp_path):
    data = np.full((24, 24, 24), 10.0, np.float32)
    data[8:16, 8:16, 8:16] = 400.0
    inp, outp = str(tmp_path / "in.nii.gz"), str(tmp_path / "out.nii.gz")
    write_image(MedicalImage(data), inp)
    proc = subprocess.run([str(runtime["build"].infer), inp, outp, "100",
                           "16", "8", "2"], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    label = read_image(outp)
    assert label.GetSize() == (24, 24, 24)
    assert label.data[12, 12, 12] == 1
    assert label.data[2, 2, 2] == 0


class _ScipyHostOps:
    """The functions JAX's ``tests/test_native.py`` holds
    ``vnet_tpu.native`` to, with its signatures."""

    window_normalize = staticmethod(_window)

    @staticmethod
    def resample3d(data, out_shape, M, offset, nearest=False):
        return ndimage.affine_transform(
            data, M, offset, output_shape=tuple(out_shape),
            order=0 if nearest else 1, mode="constant", cval=0.0,
            prefilter=False).astype(np.float32)

    @staticmethod
    def patch_grid(vol_shape, patch, stride):
        return build_patch_grid(vol_shape, patch, stride).astype(np.int64)

    @staticmethod
    def extract_patches(volume, patch, starts):
        return np.stack([volume[tuple(slice(int(a), int(a) + p)
                                      for a, p in zip(s, patch))]
                         for s in starts])

    @staticmethod
    def blend_accumulate(acc, weight, probs, window, starts):
        for prob, s in zip(probs, starts):
            sl = tuple(slice(int(a), int(a) + p)
                       for a, p in zip(s, window.shape))
            acc[sl] += prob * window[..., None]
            weight[sl] += window


def _python_pass(volume, forward, batch, patch, stride, classes):
    """``InferenceClient::Run``'s steps at spacing 1 on a volume larger
    than the patch: window [0, 600] -> [0, 255], resample onto the same
    grid, patch grid, batches padded by repeating the last patch, blend
    with a window of ones, argmax, nearest resample back. Returns the label
    and the blended probabilities."""
    host = _jax_native() or _ScipyHostOps
    shape = volume.shape
    eye, zero = np.eye(3), np.zeros(3)
    windowed = host.window_normalize(volume, 0.0, 600.0)
    grid = host.resample3d(windowed, shape, eye, zero)
    starts = host.patch_grid(shape, patch, stride)
    acc = np.zeros(shape + (classes,), np.float32)
    weight = np.zeros(shape, np.float32)
    for first in range(0, len(starts), batch):
        block = starts[first:first + batch]
        patches = host.extract_patches(grid[..., None], patch, block)
        padded = np.concatenate(
            [patches] + [patches[-1:]] * (batch - len(block)))
        probs = np.asarray(forward(padded), np.float32)[:len(block)]
        host.blend_accumulate(acc, weight, probs,
                              np.ones(patch, np.float32), block)
    label = np.argmax(acc, axis=-1).astype(np.float32)
    return (host.resample3d(label, shape, eye, zero, nearest=True),
            acc / weight[..., None])


def test_cli_with_package_matches_a_python_pass(runtime, tmp_path):
    volume = np.random.default_rng(13).normal(
        300.0, 150.0, size=(24, 24, 24)).astype(np.float32)
    inp, outp = str(tmp_path / "in.nii.gz"), str(tmp_path / "out.nii")
    write_image(MedicalImage(volume), inp)
    proc = subprocess.run(
        [str(runtime["build"].infer), inp, outp, "128", "16", "8", "2",
         runtime["package"], "2"], capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "device: cpu" in proc.stdout
    label = read_image(outp)
    assert label.GetSize() == volume.shape
    expected, probs = _python_pass(volume, runtime["forward"],
                                   PACKAGE_SHAPE[0], (16, 16, 16), (8, 8, 8),
                                   classes=2)
    top2 = np.sort(probs, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) <= TIE
    differ = label.data != expected
    assert not (differ & ~tie).any(), int((differ & ~tie).sum())
    assert set(np.unique(label.data).tolist()) == {0, 1}


def test_cli_refuses_a_patch_the_package_was_not_exported_for(runtime,
                                                              tmp_path):
    inp = str(tmp_path / "in.nii")
    write_image(MedicalImage(np.zeros((24, 24, 24), np.float32)), inp)
    proc = subprocess.run(
        [str(runtime["build"].infer), inp, str(tmp_path / "out.nii"), "128",
         "8", "8", "2", runtime["package"], "2"], capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 2
    assert "(2, 16, 16, 16, 1)" in proc.stderr
