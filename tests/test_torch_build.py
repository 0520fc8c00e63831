"""Where ``ops/cuda_build.py`` puts a kernel's build.

The library's name carries a hash of its source, of the ``csrc`` headers
the source includes and of the compiler flags, so an edited header
rebuilds every kernel that includes it and no other.  The checks run on
copies of ``csrc`` in a temporary directory; nothing is compiled.
"""

import os
import shutil

import pytest

from stereo_rcnn_tpu_torch.ops import cuda_build

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
