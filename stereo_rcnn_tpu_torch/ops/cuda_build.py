"""Build a CUDA source of ``csrc/`` with nvcc and load it with ctypes.

The library is compiled at first use for ``sm_90a`` into
``stereo_rcnn_tpu_torch/csrc/build/`` (git-ignored), under a name keyed by
a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing here falls back: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")


class BuildInfo(NamedTuple):
    """What a :func:`load_library` call did, for reports."""

    path: str
    seconds: float      # 0.0 when the library was already built
    log: str            # nvcc's output (ptxas register counts)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{cuda_home}/bin); the CUDA kernels cannot be built")


def load_library(source: str) -> tuple[ctypes.CDLL, BuildInfo]:
    """Compile ``csrc/<source>`` if its hashed build is missing; load it."""
    src_path = os.path.join(CSRC, source)
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    lib_path = os.path.join(BUILD_DIR,
                            f"lib{stem}.{digest.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source} "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
    return ctypes.CDLL(lib_path), BuildInfo(lib_path, seconds, log)
