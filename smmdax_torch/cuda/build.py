"""Build and load the hand-written CUDA kernels of ``smmdax_torch/csrc``.

``pair_sum.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  The library
goes to ``smmdax_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the source and flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing is built when the package is imported:
the first kernel launch builds, or ``build()`` does it up front.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Tuple

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
SOURCE = "pair_sum.cu"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target() -> str:
    with open(os.path.join(CSRC_DIR, SOURCE), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(SOURCE)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build() -> Tuple[str, str, float]:
    """Compile the source unless its library is current.

    Returns (library path, nvcc output, seconds)."""
    t0 = time.perf_counter()
    out = _target()
    log = ""
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{log}")
        os.replace(tmp, out)    # atomic: a concurrent loader never sees half a file
    return out, log, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    return ctypes.CDLL(build()[0])


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        lib.smmdax_error_string.restype = ctypes.c_char_p
        lib.smmdax_error_string.argtypes = [ctypes.c_int]
        msg = lib.smmdax_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
