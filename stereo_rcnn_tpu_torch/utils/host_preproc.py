"""ctypes bridge to the native host-preprocessing library (csrc/).

A copy of ``stereo_rcnn_tpu.utils.host_preproc`` over the port's own
byte-identical ``csrc/host_preproc.cpp``: compiled on first use with g++
(-O3 -fopenmp) into the git-ignored ``csrc/build/``, with a numpy fallback
when no compiler is available.  This is host code (the input pipeline's
resize, mean subtraction and padding), not a card kernel.
:func:`native_available` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_CSRC = os.path.join(os.path.dirname(__file__), "..", "csrc")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _self_test(lib: ctypes.CDLL) -> bool:
    """Run the native path on a tiny input and compare against the numpy
    fallback — rejects a stale/foreign binary before it serves real data."""
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (13, 17, 3)).astype(np.uint8)
    means = np.array([10.0, 20.0, 30.0], np.float32)
    dst = np.zeros((10, 20, 3), np.float32)
    try:
        lib.resize_subtract_pad(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 13, 17,
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 10, 20,
            ctypes.c_float(0.7),
            means.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    except Exception:
        return False
    want = _numpy_fallback(src, 10, 20, 0.7, means)
    return bool(np.allclose(dst, want, atol=1.0))   # sanity, not precision


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        src = os.path.abspath(os.path.join(_CSRC, "host_preproc.cpp"))
        out_dir = os.path.join(_CSRC, "build")
        os.makedirs(out_dir, exist_ok=True)
        # Portable flags only (no -march=native: a prebuilt binary moved to
        # another microarchitecture could SIGILL inside the pipeline).  The
        # kernel is memory-bound, so target-specific codegen buys little.
        cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC"]
        # Rebuild is keyed on a (source, flags) hash, not mtimes — a fresh
        # checkout resets mtimes and must not resurrect a stale binary.
        tag = hashlib.sha256()
        with open(src, "rb") as f:
            tag.update(f.read())
        tag.update(" ".join(cmd).encode())
        so = os.path.join(out_dir,
                          f"libhost_preproc.{tag.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            # Built under a private name, then renamed: processes that
            # build at once never load a half-written library.
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                subprocess.run(cmd + [src, "-o", tmp], check=True,
                               capture_output=True)
            except (subprocess.CalledProcessError, FileNotFoundError):
                try:  # retry without -fopenmp
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp],
                        check=True, capture_output=True)
                except (subprocess.CalledProcessError, FileNotFoundError):
                    return None
            os.replace(tmp, so)
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.resize_subtract_pad.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float)]
        if not _self_test(lib):
            return None
        _LIB = lib
        return _LIB


def _numpy_fallback(src: np.ndarray, dst_h: int, dst_w: int, scale: float,
                    means: np.ndarray) -> np.ndarray:
    sh, sw = src.shape[:2]
    oh = min(dst_h, int(sh * scale + 0.5))
    ow = min(dst_w, int(sw * scale + 0.5))
    ys = np.clip((np.arange(oh) + 0.5) / scale - 0.5, 0, sh - 1)
    xs = np.clip((np.arange(ow) + 0.5) / scale - 0.5, 0, sw - 1)
    y0 = np.clip(ys.astype(int), 0, sh - 1)
    x0 = np.clip(xs.astype(int), 0, sw - 1)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    im = src.astype(np.float32)
    top = im[y0][:, x0] * (1 - fx) + im[y0][:, x1] * fx
    bot = im[y1][:, x0] * (1 - fx) + im[y1][:, x1] * fx
    out = np.zeros((dst_h, dst_w, 3), np.float32)
    out[:oh, :ow] = top * (1 - fy) + bot * fy - means
    return out


def resize_subtract_pad(src: np.ndarray, dst_h: int, dst_w: int,
                        scale: float, means: Sequence[float],
                        force_numpy: bool = False) -> np.ndarray:
    """uint8 [H, W, 3] BGR -> float32 [dst_h, dst_w, 3], scaled by `scale`,
    mean-subtracted, zero-padded bottom/right."""
    means_arr = np.asarray(means, np.float32)
    src = np.ascontiguousarray(src, np.uint8)
    lib = None if force_numpy else _build_and_load()
    if lib is None:
        return _numpy_fallback(src, dst_h, dst_w, scale, means_arr)
    dst = np.zeros((dst_h, dst_w, 3), np.float32)
    lib.resize_subtract_pad(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        src.shape[0], src.shape[1],
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dst_h, dst_w, ctypes.c_float(scale),
        means_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return dst


def native_available() -> bool:
    return _build_and_load() is not None
