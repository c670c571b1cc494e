"""The port's native runtime: ctypes bindings for its host ops and the build
of its C++ sources, the counterpart of ``vnet_tpu/native.py``.

``csrc/native/`` holds byte-for-byte copies of the JAX package's host
runtime (``host_ops.cc``, ``nifti_io.{h,cc}``, ``inference_client.{h,cc}``,
``thread_pool.h``, ``safe_queue.h``) beside the port's own sources:
``libtorch_executor.{h,cc}`` (the forward of an AOTInductor package from
``vnet_tpu_torch.export``, in the place of the PJRT executor),
``main.cc`` (the ``vnet_infer_torch`` CLI) and ``native_test.cc`` (the C++
tests). :func:`build` compiles them with ``g++`` (no cmake or ninja) at
first use, against the installed PyTorch's headers and libraries
(``torch.utils.cpp_extension``; ``libtorch_cuda`` too where PyTorch has
CUDA), into three targets under ``_build/native_<hash>/`` (the hash covers
the sources, the flags and the PyTorch version):

* ``libvnet_host_torch.so``: the host ops, bound below;
* ``vnet_infer_torch``: ``<in> <out> [threshold patch stride threads]
  [model.pt2 num_classes] [window_min window_max spacing]``;
* ``vnet_native_test_torch``: ``<tmpdir> [package input.f32
  expected.f32]``.

Processes that build at once (test workers) take a file lock: one compiles
into a private directory that an atomic rename publishes, and the others
find it when they get the lock. A build error raises
:class:`NativeBuildError` (a missing ``zlib.h`` says so: the NIfTI reader
needs zlib for ``.nii.gz``); nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .ops.build import PACKAGE_DIR, build_dir

NATIVE_DIR = PACKAGE_DIR / "csrc" / "native"
HOST_SOURCES = ("host_ops.cc", "nifti_io.cc", "inference_client.cc")
HOST_LIBRARY = "libvnet_host_torch.so"
# executable -> its main source; both link the host objects and the executor
EXECUTABLES = {"vnet_infer_torch": "main.cc",
               "vnet_native_test_torch": "native_test.cc"}
CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-pthread")
# glue around libtorch calls: nothing hot, and a lower level compiles the
# torch headers faster
TORCH_CXX_FLAGS = ("-std=c++17", "-O1", "-fPIC", "-pthread")


class NativeBuildError(RuntimeError):
    pass


@dataclass(frozen=True)
class NativeBuild:
    """The built targets, whether this process compiled them and the
    seconds that took."""

    directory: Path
    compiled: bool
    seconds: float

    @property
    def host_library(self) -> Path:
        return self.directory / HOST_LIBRARY

    @property
    def infer(self) -> Path:
        return self.directory / "vnet_infer_torch"

    @property
    def test(self) -> Path:
        return self.directory / "vnet_native_test_torch"


def compiler() -> str:
    """The ``g++`` on ``PATH``, which builds the native targets and the
    C++ wrapper of every AOTInductor package (``export.py``)."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("g++ not found; the port's native runtime is "
                               "built from source at first use")
    return cxx


@functools.cache
def _torch_flags():
    """``(include flags, link flags)`` of the installed PyTorch."""
    from torch.utils import cpp_extension

    includes = [f"-I{p}" for p in cpp_extension.include_paths()]
    libdir = cpp_extension.library_paths()[0]
    libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    if torch.version.cuda is not None:
        libs += ["-ltorch_cuda", "-lc10_cuda"]
    # keep the CUDA libraries, whose static initialisers register the CUDA
    # device guard and the AOTInductor CUDA runner; their own dependencies
    # (the CUDA runtime) are found at run time through their RUNPATH
    link = [f"-L{libdir}", f"-Wl,-rpath,{libdir}", "-Wl,--no-as-needed",
            *libs, "-Wl,--as-needed", "-Wl,--allow-shlib-undefined"]
    return includes, link


def _abi_flag() -> str:
    return f"-D_GLIBCXX_USE_CXX11_ABI={int(torch.compiled_with_cxx11_abi())}"


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(NATIVE_DIR.iterdir()):
        if path.suffix in (".h", ".cc"):
            h.update(path.name.encode() + b"\0" + path.read_bytes())
    includes, link = _torch_flags()
    h.update(" ".join((compiler(), *CXX_FLAGS, *TORCH_CXX_FLAGS, _abi_flag(),
                       *includes, *link, torch.__version__)).encode())
    return h.hexdigest()[:16]


def _run_all(commands, what: str) -> None:
    """Run the commands at once; raise with the log of the first failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in commands]
    failed = []
    for cmd, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append((cmd, proc.returncode, log))
    if not failed:
        return
    cmd, code, log = failed[0]
    hint = ""
    if "zlib.h" in log or "-lz" in log:
        hint = ("zlib's headers or library are missing: nifti_io.cc reads "
                "and writes .nii.gz through zlib (zlib.h, -lz)\n")
    raise NativeBuildError(f"{what} failed (exit {code}): {' '.join(cmd)}\n"
                           f"{hint}{log}")


def _compile_into(out: Path) -> None:
    cxx, abi = compiler(), _abi_flag()
    includes, link = _torch_flags()
    src = str(NATIVE_DIR)
    objects = {}
    compiles = []
    for name in (*HOST_SOURCES, "libtorch_executor.cc",
                 *EXECUTABLES.values()):
        obj = out / (Path(name).stem + ".o")
        objects[name] = str(obj)
        flags = (TORCH_CXX_FLAGS + tuple(includes)
                 if name == "libtorch_executor.cc" else CXX_FLAGS)
        compiles.append([cxx, *flags, abi, f"-I{src}", "-c",
                         str(NATIVE_DIR / name), "-o", str(obj)])
    _run_all(compiles, "g++")
    host = [objects[name] for name in HOST_SOURCES]
    links = [[cxx, "-shared", "-pthread", "-o", str(out / HOST_LIBRARY),
              *host, "-lz"]]
    for exe, main in EXECUTABLES.items():
        links.append([cxx, "-pthread", "-o", str(out / exe), objects[main],
                      objects["libtorch_executor.cc"], *host, *link, "-lz"])
    _run_all(links, "link")
    for obj in objects.values():
        os.remove(obj)


@functools.cache
def build() -> NativeBuild:
    """Build the three targets unless this source hash is built; cached
    per process. Safe when several processes call it at once."""
    directory = build_dir()
    out = directory / f"native_{_digest()}"
    if out.is_dir():
        return NativeBuild(out, False, 0.0)
    try:
        directory.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        raise NativeBuildError(f"cannot create the build directory "
                               f"{directory}: {e}") from e
    with open(directory / f"{out.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.is_dir():  # another process built it meanwhile
            return NativeBuild(out, False, 0.0)
        tmp = directory / f"{out.name}.{os.getpid()}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        t0 = time.perf_counter()
        try:
            _compile_into(tmp)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        os.rename(tmp, out)
        return NativeBuild(out, True, time.perf_counter() - t0)


def available() -> bool:
    """Whether the host library of these sources is built (no build)."""
    return (build_dir() / f"native_{_digest()}" / HOST_LIBRARY).exists()


_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The host library, built at first use."""
    lib = ctypes.CDLL(str(build().host_library))
    lib.vnet_host_ops_version.restype = ctypes.c_int
    lib.vnet_host_ops_version.argtypes = []
    lib.vnet_window_normalize.restype = None
    lib.vnet_window_normalize.argtypes = [
        _f32p, _f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float]
    lib.vnet_resample3d.restype = None
    lib.vnet_resample3d.argtypes = [
        _f32p, _i64p, _f32p, _i64p, _f64p, _f64p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int]
    lib.vnet_patch_grid.restype = ctypes.c_int64
    lib.vnet_patch_grid.argtypes = [_i64p, _i64p, _i64p, _i64p,
                                    ctypes.c_int64]
    lib.vnet_extract_patches.restype = None
    lib.vnet_extract_patches.argtypes = [
        _f32p, _i64p, ctypes.c_int64, _i64p, _i64p, ctypes.c_int64, _f32p,
        ctypes.c_int]
    lib.vnet_blend_accumulate.restype = None
    lib.vnet_blend_accumulate.argtypes = [
        _f32p, _f32p, _i64p, ctypes.c_int64, _f32p, _f32p, _i64p, _i64p,
        ctypes.c_int64]
    return lib


def window_normalize(data: np.ndarray, lo: float, hi: float,
                     out_min: float = 0.0, out_max: float = 255.0) -> np.ndarray:
    """``clip((x - lo) * (out_max - out_min) / (hi - lo) + out_min)``."""
    src = np.ascontiguousarray(data, np.float32)
    out = np.empty_like(src)
    _lib().vnet_window_normalize(src.reshape(-1), out.reshape(-1), src.size,
                                 lo, hi, out_min, out_max)
    return out


def resample3d(data: np.ndarray, out_shape, M: np.ndarray, offset: np.ndarray,
               nearest: bool = False, default_value: float = 0.0,
               num_threads: int = 4) -> np.ndarray:
    """Resample with continuous-index map c = M @ o + offset (the contract
    of ``scipy.ndimage.affine_transform`` with order <= 1)."""
    src = np.ascontiguousarray(data, np.float32)
    if src.ndim != 3:
        raise ValueError(f"resample3d takes a 3D volume, got {src.shape}")
    out = np.empty(tuple(int(s) for s in out_shape), np.float32)
    _lib().vnet_resample3d(
        src, np.asarray(src.shape, np.int64), out,
        np.asarray(out.shape, np.int64),
        np.ascontiguousarray(M, np.float64).reshape(9),
        np.ascontiguousarray(offset, np.float64).reshape(3),
        0 if nearest else 1, default_value, num_threads)
    return out


def patch_grid(vol_shape, patch, stride) -> np.ndarray:
    """``(N, 3)`` patch starts, strides clamped at the far edge."""
    lib = _lib()
    vs = np.asarray(vol_shape, np.int64)
    p = np.asarray(patch, np.int64)
    s = np.asarray(stride, np.int64)
    n = lib.vnet_patch_grid(vs, p, s, np.zeros(3, np.int64), 0)
    starts = np.zeros((int(n), 3), np.int64)
    lib.vnet_patch_grid(vs, p, s, starts.reshape(-1), n)
    return starts


def extract_patches(volume: np.ndarray, patch, starts: np.ndarray,
                    num_threads: int = 4) -> np.ndarray:
    """volume (X, Y, Z, C) f32, starts (N, 3) -> (N, *patch, C)."""
    vol = np.ascontiguousarray(volume, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    p = tuple(int(x) for x in patch)
    if vol.ndim != 4 or starts.ndim != 2 or starts.shape[1] != 3:
        raise ValueError(f"volume {vol.shape}, starts {starts.shape}")
    if ((starts < 0).any()
            or (starts + np.asarray(p) > np.asarray(vol.shape[:3])).any()):
        raise ValueError("a patch leaves the volume")
    c, n = vol.shape[-1], starts.shape[0]
    out = np.empty((n, *p, c), np.float32)
    _lib().vnet_extract_patches(
        vol.reshape(-1), np.asarray(vol.shape[:3], np.int64), c,
        np.asarray(p, np.int64), starts.reshape(-1), n, out.reshape(-1),
        num_threads)
    return out


def blend_accumulate(acc: np.ndarray, weight: np.ndarray, probs: np.ndarray,
                     window: np.ndarray, starts: np.ndarray) -> None:
    """In place: acc (X, Y, Z, C) += probs (N, *patch, C) * window;
    weight (X, Y, Z) += window."""
    if not (acc.dtype == weight.dtype == np.float32
            and acc.flags.c_contiguous and weight.flags.c_contiguous):
        raise ValueError("acc and weight must be C-contiguous float32")
    starts = np.ascontiguousarray(starts, np.int64)
    patch = probs.shape[1:4]
    if (acc.ndim != 4 or weight.shape != acc.shape[:3]
            or probs.shape[0] != starts.shape[0]
            or probs.shape[-1] != acc.shape[-1]
            or window.shape != patch):
        raise ValueError(f"acc {acc.shape}, weight {weight.shape}, probs "
                         f"{probs.shape}, window {window.shape}, starts "
                         f"{starts.shape}")
    if ((starts < 0).any()
            or (starts + np.asarray(patch) > np.asarray(acc.shape[:3])).any()):
        raise ValueError("a patch leaves the volume")
    _lib().vnet_blend_accumulate(
        acc.reshape(-1), weight.reshape(-1),
        np.asarray(acc.shape[:3], np.int64), acc.shape[-1],
        np.ascontiguousarray(probs, np.float32).reshape(-1),
        np.ascontiguousarray(window, np.float32).reshape(-1),
        np.asarray(patch, np.int64), starts.reshape(-1), probs.shape[0])
