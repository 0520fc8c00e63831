"""Profiling hooks on ``torch.profiler``.

Port of ``stereo_rcnn_tpu.utils.profiling``: :func:`trace` records the
enclosed block (host ranges, and the card's kernels where there is one)
and writes a Chrome trace into ``log_dir``; :func:`annotate` names a
range in it; :func:`wall` prints a block's wall seconds.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str = "runs/torch_trace") -> Iterator[profile]:
    """Profile the enclosed block; the trace lands in
    ``<log_dir>/trace.json`` (Perfetto or chrome://tracing)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named range in the trace timeline."""
    with record_function(name):
        yield


@contextlib.contextmanager
def wall(name: str, sink=print) -> Iterator[None]:
    t0 = time.time()
    yield
    sink(f"{name}: {time.time() - t0:.3f}s")
