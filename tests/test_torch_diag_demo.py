"""The port's ``tools.diag_3d`` and ``tools.demo`` on the CPU at the tiny
config: the IoU matrix against the JAX tool's (exactly: the same numpy
code), ``diag_3d`` printing every row on a port checkpoint, and the demo's
PNG (written with zlib and struct, decoded here the same way) holding the
three panels, the 2D boxes' colours at the detections' corners.
"""

import dataclasses
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from stereo_rcnn_tpu_torch.config import save_config, tiny_test_config
from stereo_rcnn_tpu_torch.tools import demo, diag_3d
from stereo_rcnn_tpu_torch.train import init_train_state
from stereo_rcnn_tpu_torch.train.checkpoint import save_checkpoint

from tools.diag_3d import _iou_matrix as j_iou_matrix

ROWS = ("depth dz", "aligned-z dz (raw)", "lateral dx", "vertical dy",
        "dims dh", "dims dw", "dims dl", "viewpoint dalpha", "yaw dry",
        "keypoint du", "box disparity err")


def test_iou_matrix_equals_the_jax_tools():
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 200, (2, 9, 2)).astype(np.float32)
    wh = rng.uniform(0, 80, (2, 9, 2)).astype(np.float32)
    wh[0, 0] = 0.0                                  # a zero-area box
    a = np.concatenate([xy[0], xy[0] + wh[0]], -1)
    b = np.concatenate([xy[1], xy[1] + wh[1]], -1)
    b[3] = a[5]                                     # one identical pair
    ours = diag_3d._iou_matrix(a, b)
    np.testing.assert_array_equal(ours, j_iou_matrix(a, b))
    assert ours[5, 3] == pytest.approx(1.0)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    cfg = dataclasses.replace(tiny_test_config(), compute_dtype="float32")
    ckpt = str(tmp_path_factory.mktemp("diag") / "ckpt")
    save_checkpoint(ckpt, init_train_state(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    save_config(cfg, os.path.join(ckpt, "config.json"))
    return ckpt


def test_diag_3d_prints_every_row(tiny_ckpt, capsys):
    """At IoU 0 every detection meets some gt and each gt takes at most
    one (greedy), so every row has numbers."""
    assert diag_3d.main(["--ckpt-dir", tiny_ckpt, "--batches", "1",
                         "--batch", "2", "--iou", "0", "--platform",
                         "cpu"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0].startswith("step 0, matching at 2D IoU >= 0")
    n_det, n_gt, n_match = (int(lines[1].split()[i]) for i in (0, 3, 6))
    assert lines[1].endswith("matched") and 0 < n_match <= min(n_det, n_gt)
    for row in ROWS:
        hits = [ln for ln in lines if ln.startswith(row)]
        assert hits and all(" n=" in ln for ln in hits), row
    assert "kpt corner-type acc" in out


def _read_png(path):
    """An unfiltered 8-bit RGB PNG as written by ``demo.write_png``."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = hdr[:2]
    assert hdr[2:] == (8, 2, 0, 0, 0)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_demo_synthetic_png(tmp_path, capsys):
    out = str(tmp_path / "demo.png")
    det, panels = demo.run(demo.parse_args([
        "--synthetic", "--tiny", "--platform", "cpu", "--out", out]))
    assert "wrote" in capsys.readouterr().out
    cfg = tiny_test_config()
    h, w = cfg.data.image_h, cfg.data.image_w
    img = _read_png(out)
    assert img.shape == (2 * h + demo.bev_side(h, w), w, 3)
    np.testing.assert_array_equal(img, panels)
    valid = np.nonzero(det.valid)[0]
    assert len(valid) > 0
    left, right = img[:h], img[h:2 * h]
    checked = 0
    for panel, boxes, colour in ((left, det.box_left, demo.LIME),
                                 (right, det.box_right, demo.CYAN)):
        for i in valid:
            x1, y1, x2, y2 = (int(np.floor(v + 0.5)) for v in boxes[i])
            for x, y in ((x1, y1), (x2, y1), (x1, y2), (x2, y2)):
                if 0 <= x < w and 0 <= y < h:
                    assert tuple(panel[y, x]) == colour, (i, x, y)
                    checked += 1
    assert checked >= 4 * len(valid)
    # Footprints in the bird's-eye panel.
    assert (img[2 * h:] == demo.GREEN).all(-1).any()
