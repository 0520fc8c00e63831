"""The ``export_model`` and ``serve`` CLIs of the port end to end on the
CPU (``--platform cpu``, in this process through ``main(argv)``), the twin
of ``tests/test_serve_cli.py``: export the tiny config as it is
(GroupNorm, bf16, the atlas gather) at batch 2 with a params export's
weights, ``--verify`` the artifact, then serve a rendered ``.npy`` KITTI
tree of 3 frames (a full batch and a padded tail) with the params export
loaded over the artifact's weights, and read the KITTI result files.
``--verify`` and ``serve`` load the same file; the test loads it once
(``serving.load_pipeline`` on the CPU spends about half a minute in
torch's deserializer) and hands both tools that one pipeline.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from stereo_rcnn_tpu_torch import serving
from stereo_rcnn_tpu_torch.config import save_config, tiny_test_config
from stereo_rcnn_tpu_torch.data.synthetic import (random_scene, render_pair,
                                                  write_kitti_frame)
from stereo_rcnn_tpu_torch.geometry.calib import default_kitti_calib
from stereo_rcnn_tpu_torch.models.detector import init_params
from stereo_rcnn_tpu_torch.tools import export_model, serve
from stereo_rcnn_tpu_torch.train.checkpoint import export_params

N_FRAMES = 3   # batch 2: one full batch and a padded tail


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_serve"))
    calib = default_kitti_calib()
    rng = np.random.RandomState(11)
    for i in range(N_FRAMES):
        objs = random_scene(rng, 2, calib, 375, 1242)
        left, right = render_pair(objs, calib, 375, 1242, rng)
        write_kitti_frame(root, f"{i:06d}", objs, calib, left, right)
    return os.path.join(root, "training")


def test_export_then_serve_cli(kitti_tree, tmp_path, capsys, monkeypatch):
    """export_model (validating a params export) and --verify, then serve
    with the params export over the artifact's weights."""
    loaded = {}
    load = serving.load_pipeline

    def load_once(blob):
        key = hashlib.sha256(blob).hexdigest()
        if key not in loaded:
            loaded[key] = load(blob)
        return loaded[key]
    monkeypatch.setattr(serving, "load_pipeline", load_once)
    cfg = tiny_test_config()
    ckpt = str(tmp_path / "ckpt")
    export_params(os.path.join(ckpt, "params_export"),
                  init_params(cfg, torch.Generator().manual_seed(2), "cpu"))
    save_config(cfg, os.path.join(ckpt, "config.json"))
    artifact, out = str(tmp_path / "model.pt2"), str(tmp_path / "results")

    assert export_model.main(["--tiny", "--platform", "cpu", "--batch", "2",
                              "--ckpt-dir", ckpt, "--out", artifact]) == 0
    stdout = capsys.readouterr().out
    assert "parameter tree validated" in stdout and "exported" in stdout
    assert export_model.main(["--verify", artifact, "--tiny",
                              "--platform", "cpu"]) == 0
    assert "verify OK: ran batch 2" in capsys.readouterr().out

    assert serve.main([
        "--artifact", artifact, "--ckpt-dir", ckpt,
        "--left-dir", os.path.join(kitti_tree, "image_2"),
        "--right-dir", os.path.join(kitti_tree, "image_3"),
        "--calib-dir", os.path.join(kitti_tree, "calib"),
        "--out", out, "--image-ext", ".npy", "--platform", "cpu"]) == 0
    stdout = capsys.readouterr().out
    assert "weights: " in stdout
    assert f"served {N_FRAMES} frames" in stdout
    assert "first batch " in stdout
    assert f"after the first batch: {N_FRAMES - 2} frames" in stdout
    assert len(loaded) == 1

    files = sorted(os.listdir(out))
    assert files == [f"{i:06d}.txt" for i in range(N_FRAMES)]
    n_lines = 0
    for fn in files:
        with open(os.path.join(out, fn)) as f:
            for line in f:
                parts = line.split()
                assert len(parts) == 16 and parts[0] == "Car"
                assert np.isfinite([float(x) for x in parts[1:]]).all()
                n_lines += 1
    assert n_lines > 0
