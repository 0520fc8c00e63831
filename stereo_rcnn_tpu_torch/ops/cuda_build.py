"""Build a CUDA source of ``csrc/`` with nvcc and load it with ctypes.

The library is compiled at first use for ``sm_90a`` into
``stereo_rcnn_tpu_torch/csrc/build/`` (git-ignored), under a name keyed by
a hash of the source, the ``csrc`` headers it includes and the flags
(:func:`library_path`), so an edited source or header is rebuilt and an
unchanged one is loaded as it is.  Nothing here falls back: a missing
``nvcc`` or a failed build raises.  :class:`CudaKernel` binds one C entry
of a source; :func:`load_kernels` builds several at once;
:func:`on_device` picks a kernel or its plain version by the tensors'
device; :func:`check_levels` checks the feature levels a kernel
reads.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

import torch

from stereo_rcnn_tpu_torch.utils.profiling import span

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


# A header of the sources' own directory: #include "name.cuh".
_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"/]+)"', re.M)


def library_path(source: str, csrc: str = CSRC) -> str:
    """The build of ``<csrc>/<source>``: ``<csrc>/build/lib<stem>.<hash>.so``,
    the hash taken over the flags, the source and every header of ``csrc``
    that it includes, directly or through another header."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    todo, seen = [source], set()
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.add(name)
        with open(os.path.join(csrc, name), "rb") as f:
            text = f.read()
        digest.update(name.encode() + b"\0" + text + b"\0")
        todo.extend(m.decode() for m in _LOCAL_INCLUDE.findall(text))
    stem = os.path.splitext(source)[0]
    return os.path.join(csrc, "build",
                        f"lib{stem}.{digest.hexdigest()[:16]}.so")


def load_library(source: str) -> tuple[ctypes.CDLL, BuildInfo]:
    """Compile ``csrc/<source>`` if its hashed build is missing; load it."""
    src_path = os.path.join(CSRC, source)
    lib_path = library_path(source)
    seconds, log = 0.0, ""
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            with span("setup/kernel_build"):
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path],
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
    with span("setup/kernel_load"):
        lib = ctypes.CDLL(lib_path)
    return lib, BuildInfo(lib_path, seconds, log)


class CudaKernel:
    """ctypes binding of one C entry of a ``csrc/`` source, built at first
    use.  ``launches`` counts kernel launches; it grows in ``__call__``
    only, right after a launch that returned no error."""

    source = ""
    symbol = ""
    argtypes: list = []

    def __init__(self):
        self.launches = 0
        self.build_info = None
        self._fn = None

    def reset_counts(self) -> None:
        self.launches = 0

    def load(self):
        if self._fn is None:
            lib, self.build_info = load_library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _launched(self, err: int) -> None:
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{err}")
        self.launches += 1


def load_kernels(kernels) -> None:
    """Build (where needed) and load ``kernels`` (:class:`CudaKernel` s)
    together: one ``nvcc`` per source, all started at once."""
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        for fut in [pool.submit(k.load) for k in kernels]:
            fut.result()


def on_device(dev, name: str, cuda_fn, cpu_fn):
    """CUDA tensors take the kernel, CPU tensors the plain version; any
    other device raises."""
    if dev.type == "cuda":
        return cuda_fn
    if dev.type == "cpu":
        return cpu_fn
    raise RuntimeError(f"{name}: no implementation for device {dev}")


def check_levels(feats, dev, b: int):
    """``(dtype, C)`` of one side's levels as the kernels read them:
    contiguous NHWC ``[b, H_l, W_l, C]`` on ``dev``, all bfloat16 or all
    float32; any C."""
    dtype = feats[0].dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"features must be bfloat16 or float32, got {dtype}")
    c = feats[0].shape[-1]
    for f in feats:
        if f.device != dev or f.dtype != dtype:
            raise ValueError("all levels must share the rois' device and one "
                             "dtype")
        if f.dim() != 4 or f.shape[0] != b or f.shape[3] != c:
            raise ValueError(f"level shape {tuple(f.shape)} is not "
                             f"[{b}, H, W, {c}]")
        if not f.is_contiguous():
            raise ValueError("levels must be contiguous NHWC")
    return dtype, c
