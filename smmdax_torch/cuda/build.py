"""Build and load the hand-written CUDA kernels of ``smmdax_torch/csrc``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, loaded with
``ctypes``; the ``nvcc`` processes run side by side.  The libraries go to
``smmdax_torch/_build/`` (listed in ``.gitignore``), named by a hash of
every file in ``csrc/`` (sources and the shared ``mixture.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged tree is
reused.  Nothing is built when the package is imported: the first kernel
launch builds, or ``build()`` does it up front.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Tuple

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

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


def _digest() -> str:
    """Hash of every file in ``csrc/`` and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def sources() -> Tuple[str, ...]:
    """The kernel sources, ``csrc/*.cu``."""
    return tuple(sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cu")))


def _target(source: str, digest: str) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build() -> Tuple[Dict[str, str], str, float]:
    """Compile every source whose library is not current, one ``nvcc``
    each, all started together.

    Returns ({source: library path}, nvcc output, seconds)."""
    t0 = time.perf_counter()
    digest = _digest()
    targets = {src: _target(src, digest) for src in sources()}
    todo = {src: out for src, out in targets.items() if not os.path.exists(out)}
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for src, out in todo.items():
            tmp = f"{out}.{os.getpid()}.tmp"
            procs[src] = (tmp, out, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = [], []
        for src, (tmp, out, proc) in procs.items():
            text, _ = proc.communicate()
            logs.append(f"== {src}\n{text}")
            if proc.returncode != 0:
                failed.append(src)
            else:
                os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(logs))
        log = "\n".join(logs)
    else:
        log = ""
    return targets, log, time.perf_counter() - t0


@functools.cache
def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    return ctypes.CDLL(build()[0][source])


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        lib.smmdax_error_string.restype = ctypes.c_char_p
        lib.smmdax_error_string.argtypes = [ctypes.c_int]
        msg = lib.smmdax_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
