"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``vnet_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on its own with ``nvcc`` for Hopper (``sm_90a``) into a shared
library named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is compiled once. The library goes to
``vnet_tpu_torch/_build/`` (listed in ``.gitignore``) in a checkout, and to
a per-user cache (``$XDG_CACHE_HOME`` or ``~/.cache``, then
``vnet_tpu_torch/``) when the package directory is read-only, as an
installed wheel's often is. A build error raises; no caller falls back to
anything else.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    pass


@dataclass(frozen=True)
class Built:
    """A loaded kernel library: ``lib``, its path, whether this process
    compiled it (``compiled``), the seconds that took and nvcc's log (with
    ``-Xptxas -v``: registers, shared memory and spills per kernel)."""

    lib: ctypes.CDLL
    path: Path
    compiled: bool
    seconds: float
    log: str


def build_dir() -> Path:
    """``_build/`` beside the package sources where that can be written,
    else the per-user cache."""
    local = PACKAGE_DIR / "_build"
    if os.access(local if local.exists() else PACKAGE_DIR, os.W_OK):
        return local
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "vnet_tpu_torch"


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = ([str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home
                  else []) + [shutil.which("nvcc") or "",
                              "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")


def load(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` if its hashed library is missing, then
    load it. Cached per process."""
    return load_source(CSRC / f"{name}.cu")


@functools.cache
def load_source(src: Path) -> Built:
    """:func:`load` for a source anywhere on disk (a benchmark's variant of
    a kernel): the library is named by the file's stem and hash. The hash
    covers that file alone, so such a variant is a whole copy of the
    kernel, not a file that includes another."""
    src = Path(src)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir()
    out = out_dir / f"lib{src.stem}_{digest}.so"
    compiled, seconds, log = False, 0.0, ""
    if not out.exists():
        try:
            out_dir.mkdir(parents=True, exist_ok=True)
        except OSError as e:
            raise KernelBuildError(
                f"cannot create the kernel build directory {out_dir}: "
                f"{e}") from e
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed for {src} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: concurrent processes agree
        compiled = True
    return Built(ctypes.CDLL(str(out)), out, compiled, seconds, log)
