"""The port's data path for the training and evaluation tools, pinned to
the JAX package's on the CPU: the KITTI tree writer, the held-out
evaluation domains, the label parser and dataset reader, the native host
preprocessing, and ``KittiPipeline``'s batches.

All comparisons are exact (these are copies, not re-implementations):
bytes of files, ``np.testing.assert_array_equal`` of arrays, dtypes
included.
"""

import dataclasses
import filecmp
import os
import sys

import numpy as np
import pytest

from stereo_rcnn_tpu import config as j_config
from stereo_rcnn_tpu.data import kitti as j_kitti
from stereo_rcnn_tpu.data import pipeline as j_pipeline
from stereo_rcnn_tpu.data import synthetic as j_synth
from stereo_rcnn_tpu.geometry.calib import default_kitti_calib as j_calib
from stereo_rcnn_tpu.utils import host_preproc as j_pre
from stereo_rcnn_tpu_torch import config as t_config
from stereo_rcnn_tpu_torch.data import kitti as t_kitti
from stereo_rcnn_tpu_torch.data import pipeline as t_pipeline
from stereo_rcnn_tpu_torch.data import synthetic as t_synth
from stereo_rcnn_tpu_torch.geometry.calib import default_kitti_calib as t_calib
from stereo_rcnn_tpu_torch.utils import host_preproc as t_pre

N_FRAMES = 10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_tree(root, synth, calib):
    """10 frames at KITTI's 1242x375, 3 objects each, every package
    rendering and writing with its own functions from the same seed; frame
    3's label gains a DontCare and a Van line, as real KITTI labels
    have."""
    rng = np.random.RandomState(7)
    for i in range(N_FRAMES):
        objs = synth.random_scene(rng, 3, calib, 375, 1242)
        left, right = synth.render_pair(objs, calib, 375, 1242, rng)
        synth.write_kitti_frame(root, f"{i:06d}", objs, calib, left, right)
    with open(os.path.join(root, "training", "label_2", "000003.txt"),
              "a") as f:
        f.write("DontCare -1 -1 -10 500.00 180.00 540.00 200.00 "
                "-1 -1 -1 -1000 -1000 -1000 -10\n")
        f.write("Van 0.00 0 -1.58 587.01 173.33 614.12 200.12 "
                "1.65 1.67 3.64 -0.65 1.71 46.70 -1.59\n")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    ours = str(tmp_path_factory.mktemp("kitti_torch"))
    theirs = str(tmp_path_factory.mktemp("kitti_jax"))
    _write_tree(ours, t_synth, t_calib())
    _write_tree(theirs, j_synth, j_calib())
    return ours, theirs


def _cfgs(root):
    out = []
    for mod in (t_config, j_config):
        cfg = mod.tiny_test_config()
        out.append(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, kitti_root=root)))
    return out


def test_write_kitti_frame_trees_are_byte_identical(trees):
    ours, theirs = trees
    for sub in ("label_2", "calib", "image_2", "image_3"):
        a = os.path.join(ours, "training", sub)
        b = os.path.join(theirs, "training", sub)
        names = sorted(os.listdir(b))
        assert sorted(os.listdir(a)) == names and len(names) == N_FRAMES
        match, mismatch, errors = filecmp.cmpfiles(a, b, names,
                                                   shallow=False)
        assert match == names, (sub, mismatch, errors)


@pytest.mark.parametrize("domain", j_synth.EVAL_DOMAINS)
def test_synthetic_batch_domains_are_byte_identical(domain):
    assert t_synth.EVAL_DOMAINS == j_synth.EVAL_DOMAINS
    ours = t_synth.synthetic_batch(t_config.tiny_test_config(), 2, seed=1003,
                                   n_objects=3, domain=domain)
    theirs = j_synth.synthetic_batch(j_config.tiny_test_config(), 2,
                                     seed=1003, n_objects=3, domain=domain)
    for a, b in zip(ours[:2], theirs[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for name in theirs[2]._fields:
        a, b = getattr(ours[2], name), getattr(theirs[2], name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(ours[3], theirs[3]):
        np.testing.assert_array_equal(a, b)


def _assert_same_record(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k in db:
        if isinstance(db[k], np.ndarray):
            assert np.asarray(da[k]).dtype == db[k].dtype, k
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)
        else:
            assert da[k] == db[k], k


def test_label_parser_and_dataset_reader_match(trees):
    """``parse_label_file`` and ``KittiDataset.load_annotation`` give equal
    objects, annotations and calibrations, ignore regions included."""
    ours, _ = trees
    cfg_t, cfg_j = _cfgs(ours)
    ds_t, ds_j = t_kitti.KittiDataset(cfg_t.data), j_kitti.KittiDataset(
        cfg_j.data)
    assert ds_t.ids == ds_j.ids and len(ds_t) == N_FRAMES
    for i in range(N_FRAMES):
        assert ds_t.paths(i) == ds_j.paths(i)
        objs_t = t_kitti.parse_label_file(ds_t.paths(i)["label"])
        objs_j = j_kitti.parse_label_file(ds_j.paths(i)["label"])
        assert len(objs_t) == len(objs_j) >= 3
        for a, b in zip(objs_t, objs_j):
            _assert_same_record(a, b)
        annos_t, calib_t = ds_t.load_annotation(i, 1242.0)
        annos_j, calib_j = ds_j.load_annotation(i, 1242.0)
        assert len(annos_t) == len(annos_j)
        for a, b in zip(annos_t, annos_j):
            _assert_same_record(a, b)
        for a, b in zip(calib_t, calib_j):
            np.testing.assert_array_equal(a, b)
    annos_t, _ = ds_t.load_annotation(3, 1242.0)
    assert sum(a.ignore for a in annos_t) == 2       # DontCare and Van


def test_host_preproc_copy_and_native_output():
    """The C++ source is a byte-identical copy; both libraries build here,
    and native output (and the numpy fallback) equal the JAX package's on
    a KITTI-sized frame."""
    assert filecmp.cmp(
        os.path.join(REPO, "stereo_rcnn_tpu", "csrc", "host_preproc.cpp"),
        os.path.join(REPO, "stereo_rcnn_tpu_torch", "csrc",
                     "host_preproc.cpp"), shallow=False)
    assert t_pre.native_available() and j_pre.native_available()
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (375, 1242, 3)).astype(np.uint8)
    means = (102.9801, 115.9465, 122.7717)
    scale = min(128 / 375, 256 / 1242)
    for force_numpy in (False, True):
        a = t_pre.resize_subtract_pad(src, 128, 256, scale, means,
                                      force_numpy=force_numpy)
        b = j_pre.resize_subtract_pad(src, 128, 256, scale, means,
                                      force_numpy=force_numpy)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_kitti_pipeline_batches_match(trees):
    """Shuffled epochs of 10 frames at batch 4 (two full batches and a
    tail of 2 padded by wrap-around), two epochs, same seed: every field
    of every batch equal, the tail's ``n_valid`` included."""
    ours, _ = trees
    cfg_t, cfg_j = _cfgs(ours)
    pipe_t = t_pipeline.KittiPipeline(cfg_t, t_kitti.KittiDataset(
        cfg_t.data), 4, seed=3, image_ext=".npy")
    pipe_j = j_pipeline.KittiPipeline(cfg_j, j_kitti.KittiDataset(
        cfg_j.data), 4, seed=3, image_ext=".npy")
    assert pipe_t.steps_per_epoch() == pipe_j.steps_per_epoch() == 3
    for _ in range(2):
        bt, bj = list(pipe_t), list(pipe_j)
        assert [b.n_valid for b in bt] == [b.n_valid for b in bj] == [4, 4, 2]
        for a, b in zip(bt, bj):
            for name in ("images_left", "images_right", "scales",
                         "content_wh"):
                x, y = getattr(a, name), getattr(b, name)
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)
            for name in b.gt._fields:
                np.testing.assert_array_equal(getattr(a.gt, name),
                                              getattr(b.gt, name), name)
            for x, y in zip(a.calib, b.calib):
                assert np.asarray(x).shape == np.asarray(y).shape
                np.testing.assert_array_equal(x, y)


def test_kitti_pipeline_raises_worker_errors(trees, monkeypatch):
    """A frame that cannot be read raises in the consumer (the JAX
    pipeline's thread would end the epoch early instead); ``.png`` without
    a decoder (cv2 and PIL made unimportable) names the ``.npy`` way
    out."""
    ours, _ = trees
    cfg_t, _ = _cfgs(ours)
    pipe = t_pipeline.KittiPipeline(cfg_t, t_kitti.KittiDataset(
        cfg_t.data, ids=["000000", "missing"]), 2, shuffle=False,
        image_ext=".npy")
    with pytest.raises(FileNotFoundError):
        list(pipe)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="image-ext .npy"):
        t_pipeline.load_image(os.path.join(ours, "x.png"))


def test_kitti_pipeline_stops_its_worker_when_closed(trees):
    """Closing the iterator after one batch stops and joins the prefetch
    thread (the JAX pipeline's would stay blocked on its full queue)."""
    import threading
    ours, _ = trees
    cfg_t, _ = _cfgs(ours)
    pipe = t_pipeline.KittiPipeline(cfg_t, t_kitti.KittiDataset(
        cfg_t.data), 2, shuffle=False, image_ext=".npy", prefetch=1)
    before = threading.active_count()
    it = iter(pipe)
    assert next(it).n_valid == 2
    closer = threading.Thread(target=it.close)
    closer.start()
    closer.join(timeout=60)
    assert not closer.is_alive()
    assert threading.active_count() == before
