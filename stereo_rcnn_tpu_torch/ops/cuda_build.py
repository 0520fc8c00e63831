"""How the port's hand-written kernels are built, launched and dispatched.

Build: a source of ``csrc/`` is compiled with nvcc for ``sm_90a`` at first
use, never at import, into ``stereo_rcnn_tpu_torch/csrc/build/``
(git-ignored), under a name keyed by a hash of the source, the ``csrc``
headers it includes and the flags (:func:`library_path`).  Nothing falls
back: a missing ``nvcc`` or a failed build raises.  :func:`load_kernels`
builds several at once.

Launch: a :class:`CudaKernel` binds one C entry; its wrapper checks and
packs its own arguments, then calls :meth:`CudaKernel.launch`, which makes
the card current only if it is not, passes its current stream, raises on
a CUDA error and counts the launch.

Dispatch, one rule (:func:`on_device`): CUDA tensors launch the kernel or
raise, CPU tensors take the plain PyTorch version, other devices raise.
A kernel that ``torch.export`` must keep as one graph node is also the op
``stereo_rcnn_tpu_torch::<name>`` (:func:`kernel_op`), called only while
:func:`traced` or under a ``TorchDispatchMode``.  :func:`check_levels`
checks the feature levels a kernel reads."""

from __future__ import annotations

import concurrent.futures
import contextlib
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
    use.  ``launches`` counts kernel launches; it grows in :meth:`launch`
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

    def launch(self, device: torch.device, *args) -> None:
        """Call the C entry with ``args`` and the current stream of the
        card ``device``, made current for the call if it is not; raise on
        a CUDA error, else count the launch."""
        fn = self.load()
        idx = device.index
        with (contextlib.nullcontext() if idx == torch.cuda.current_device()
              else torch.cuda.device(idx)):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
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


def traced(t: torch.Tensor) -> bool:
    """Whether ``t`` is seen by a tracer (``torch.export``,
    ``torch.compile``) rather than computed eagerly."""
    return torch.compiler.is_compiling() or type(t) is not torch.Tensor


def kernel_op(name: str, schema: str, card, plain, fake, eager_card=None):
    """Register ``stereo_rcnn_tpu_torch::<name>`` (``schema``, no argument
    mutated): ``card`` on CUDA tensors, ``plain`` on CPU tensors, ``fake``
    for tracers.  Returns the function callers use, which takes the op's
    arguments in its order and dispatches by its first tensor (a list's
    first): traced or under a ``TorchDispatchMode`` (which then sees the
    call), the registered op; eagerly, ``eager_card`` (``card`` when None)
    on a card, ``plain`` on the CPU, and any other device raises."""
    op = torch.library.custom_op(f"stereo_rcnn_tpu_torch::{name}", plain,
                                 mutates_args=(), device_types="cpu",
                                 schema=schema)
    op.register_kernel("cuda")(card)
    op.register_fake(fake)
    registered = getattr(torch.ops.stereo_rcnn_tpu_torch, name).default
    on_card = card if eager_card is None else eager_card

    def call(*args):
        t = args[0] if isinstance(args[0], torch.Tensor) else args[0][0]
        if traced(t) or torch._C._len_torch_dispatch_stack():
            return registered(*args)
        return on_device(t.device, name, on_card, plain)(*args)
    return call


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
