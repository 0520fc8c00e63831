"""Where ``ops/cuda_build.py`` puts a kernel's build, and its dispatch rule
for the three kernels that are registered ops.

The library's name carries a hash of its source, of the ``csrc`` headers
the source includes and of the compiler flags, so an edited header
rebuilds every kernel that includes it and no other.  The checks run on
copies of ``csrc`` in a temporary directory; nothing is compiled.

Each function :func:`cuda_build.kernel_op` returns (K1's forward, K5, K6)
computes the plain version on CPU tensors, calls its registered op once
under a ``TorchDispatchMode`` and leaves one node of it in a
``torch.export`` program.
"""

import os
import shutil

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stereo_rcnn_tpu_torch.data.synthetic import (synthetic_roi_inputs,
                                                  synthetic_solve_inputs)
from stereo_rcnn_tpu_torch.geometry.calib import StereoCalib
from stereo_rcnn_tpu_torch.ops import conv_epilogue as ce
from stereo_rcnn_tpu_torch.ops import cuda_build
from stereo_rcnn_tpu_torch.ops import stereo_roi_align as sra
from stereo_rcnn_tpu_torch.solve import box_estimator as be

SOURCES = sorted(f for f in os.listdir(cuda_build.CSRC) if f.endswith(".cu"))
# The kernels that share the channel-vector helpers of csrc/vec.cuh.
WITH_VEC = ["roi_align_window.cu", "stereo_roi_align.cu",
            "stereo_roi_align_atlas.cu"]


@pytest.fixture
def csrc(tmp_path):
    """A copy of the sources and headers of ``csrc``, without builds."""
    dst = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, dst,
                    ignore=shutil.ignore_patterns("build"))
    return str(dst)


def _append(path, text):
    with open(path, "a") as f:
        f.write(text)


def test_library_path_is_keyed_by_content_not_place(csrc):
    """The same files give the same library name in any directory, inside
    that directory's ``build``."""
    for source in SOURCES:
        ours = cuda_build.library_path(source, csrc)
        theirs = cuda_build.library_path(source)
        assert os.path.dirname(ours) == os.path.join(csrc, "build")
        assert os.path.basename(ours) == os.path.basename(theirs)
        assert os.path.basename(ours).startswith(
            "lib" + os.path.splitext(source)[0] + ".")


@pytest.mark.parametrize("source", WITH_VEC)
def test_library_path_follows_an_included_header(csrc, source):
    """Editing vec.cuh renames the library of a source that includes it."""
    before = cuda_build.library_path(source, csrc)
    _append(os.path.join(csrc, "vec.cuh"), "\n// edited\n")
    assert cuda_build.library_path(source, csrc) != before


def test_header_edit_leaves_other_kernels(csrc):
    """K2 includes no csrc header: editing vec.cuh keeps its library; an
    edit of its own source renames it."""
    source = "stereo_roi_align_bwd.cu"
    before = cuda_build.library_path(source, csrc)
    _append(os.path.join(csrc, "vec.cuh"), "\n// edited\n")
    assert cuda_build.library_path(source, csrc) == before
    _append(os.path.join(csrc, source), "\n// edited\n")
    assert cuda_build.library_path(source, csrc) != before


def test_local_includes_name_files_of_csrc():
    """Every ``#include "..."`` of a source names a file beside it, and the
    three RoIAlign forward kernels include vec.cuh."""
    for source in SOURCES:
        with open(os.path.join(cuda_build.CSRC, source), "rb") as f:
            names = cuda_build._LOCAL_INCLUDE.findall(f.read())
        for name in names:
            assert os.path.isfile(os.path.join(cuda_build.CSRC,
                                               name.decode()))
        assert (b"vec.cuh" in names) == (source in WITH_VEC), source


def _k1():
    fl, fr, rl, rr = synthetic_roi_inputs(1, 4, r=8)
    args = (fl, fr, rl, rr, [4, 8, 16, 32], "kron_bf16")
    return sra.stereo_roi_align_fwd, args, sra.stereo_roi_align_packed_ref(
        *args)


def _k5():
    d = {k: torch.from_numpy(v)
         for k, v in synthetic_solve_inputs(8, seed=0).items()}
    cal = d["calib"].T.contiguous()
    args = (d["obs"], d["obs_weights"], d["dims_hwl"], d["alpha"],
            d["kpt_idx"], *cal, None, 30, 1e-3)
    ref = be.solve_batch_ref(d["obs"], d["dims_hwl"], d["alpha"],
                             d["kpt_idx"], StereoCalib(*cal, None, None),
                             d["obs_weights"], 30, 1e-3)
    return be.gauss_newton_solve, args, tuple(ref)


def _k6():
    gen = torch.Generator().manual_seed(0)
    y, r = [torch.randn(2, 8, 3, 5, generator=gen).contiguous(
        memory_format=torch.channels_last) for _ in range(2)]
    bias = torch.randn(8, generator=gen)
    args = (y, bias, r, True)
    return ce.conv_epilogue, args, ce.conv_epilogue_ref(*args)


OPS = {"stereo_roi_align_fwd": _k1, "gauss_newton_solve": _k5,
       "conv_epilogue": _k6}


def _same(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(OPS))
def test_eager_cpu_call_is_the_plain_version(name):
    fn, args, ref = OPS[name]()
    _same(fn(*args), ref)


class _OpNames(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func._schema.name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", sorted(OPS))
def test_dispatch_mode_sees_one_call_of_the_op(name):
    fn, args, ref = OPS[name]()
    with _OpNames() as mode:
        got = fn(*args)
    assert mode.names.count(f"stereo_rcnn_tpu_torch::{name}") == 1
    _same(got, ref)


@pytest.mark.parametrize("name", sorted(OPS))
def test_export_keeps_the_op_as_one_node(name):
    fn, args, _ = OPS[name]()

    class Call(torch.nn.Module):
        def forward(self, *args):
            return fn(*args)

    program = torch.export.export(Call(), args, strict=False)
    op = getattr(torch.ops.stereo_rcnn_tpu_torch, name).default
    nodes = [n for n in program.graph.nodes
             if n.op == "call_function" and n.target is op]
    assert len(nodes) == 1
