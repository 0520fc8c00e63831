"""The port runs where JAX cannot be imported.

A subprocess installs a ``sys.meta_path`` finder that refuses ``jax``,
``flax``, ``optax``, ``orbax``, ``yaml``, ``matplotlib``, ``cv2`` and
``PIL``, imports the port (the
windowed RoIAlign and the ``bench_roialign`` tool included), builds the
tiny frozen-BN config and runs ``make_full_pipeline`` on the CPU with the
fused RoIAlign and with the atlas gather (``roi_align_impl="xla"``), then
one training step of the tiny GroupNorm config (``train/``,
``data/kitti.py`` and the RoIAlign autograd Function), as the card's
machine (which has no JAX) must.  Then it imports every module of the
training and evaluation tools (``tools.train``, ``supervise_train``,
``eval_synth``, ``test_net``, ``smoke_e2e`` and what they use) and runs
one ``tools.train`` step of that config, given as JSON, on a ``.npy``
KITTI tree.  Last it imports the serving, calibration, diagnosis, demo
and upstream-import modules and runs ``tools.demo`` (which also refuses
matplotlib, cv2 and PIL: the card's machine has none of them).
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib.abc
    import sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml",
               "matplotlib", "cv2", "PIL")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    for mod in list(sys.modules):
        if mod.split(".")[0] in BLOCKED:
            del sys.modules[mod]

    import dataclasses

    import numpy as np
    import torch

    import stereo_rcnn_tpu_torch as srt
    from stereo_rcnn_tpu_torch.convert import from_jax  # noqa: F401
    from stereo_rcnn_tpu_torch.ops import roi_align_window  # noqa: F401
    from stereo_rcnn_tpu_torch.tools import bench_roialign  # noqa: F401

    base = srt.tiny_test_config()
    cfg = dataclasses.replace(
        base, compute_dtype="float32",
        backbone=dataclasses.replace(base.backbone, norm="frozen"),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas"))
    model = srt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    il, ir, calib = srt.synthetic_images(cfg, 1, seed=7, n_objects=2)
    d = cfg.rcnn.max_detections
    # The fused kernel's plain version, then the atlas gather (Config()'s
    # own RoIAlign), on the same weights.
    for impl in ("pallas", "xla"):
        cfg_i = dataclasses.replace(cfg, rcnn=dataclasses.replace(
            cfg.rcnn, roi_align_impl=impl))
        model.cfg = cfg_i
        out = srt.make_full_pipeline(cfg_i, calib)(
            model, torch.from_numpy(il), torch.from_numpy(ir))
        assert out.position.shape == (1, d, 3), out.position.shape
        valid = out.det.valid.numpy()
        assert np.isfinite(out.position.numpy()[valid]).all()

    from stereo_rcnn_tpu_torch.config import synthetic_fullres_config
    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_batch
    from stereo_rcnn_tpu_torch.train import (Batch, init_train_state,
                                             make_train_step)
    assert synthetic_fullres_config().backbone.norm == "group"
    cfg = dataclasses.replace(srt.tiny_test_config(), compute_dtype="float32")
    cfg = dataclasses.replace(cfg, rcnn=dataclasses.replace(
        cfg.rcnn, roi_align_impl="pallas"))
    il, ir, gt, _ = synthetic_batch(cfg, 1, seed=0, n_objects=2)
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    metrics = make_train_step(cfg, 10, device="cpu")(
        state, Batch(il, ir, gt), torch.Generator().manual_seed(1))
    assert state.step == 1
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics

    # The training and evaluation tools and the modules under them, and
    # one tools.train step from a .npy KITTI tree with a JSON config.
    import importlib
    import os
    for name in ("config", "data.kitti", "data.pipeline", "data.synthetic",
                 "evalkit", "evalkit.kitti_eval", "evalkit.rotate_iou",
                 "train.checkpoint", "utils.host_preproc", "utils.metrics",
                 "utils.profiling", "tools.train", "tools.supervise_train",
                 "tools.eval_synth", "tools.test_net", "tools.smoke_e2e"):
        importlib.import_module("stereo_rcnn_tpu_torch." + name)
    from stereo_rcnn_tpu_torch.config import save_config
    from stereo_rcnn_tpu_torch.data.synthetic import (random_scene,
                                                      render_pair,
                                                      write_kitti_frame)
    from stereo_rcnn_tpu_torch.geometry.calib import default_kitti_calib
    from stereo_rcnn_tpu_torch.tools import train as train_cli
    work = sys.argv[1]
    kcalib = default_kitti_calib()
    rng = np.random.RandomState(0)
    for i in range(2):
        objs = random_scene(rng, 2, kcalib, 375, 1242)
        left, right = render_pair(objs, kcalib, 375, 1242, rng)
        write_kitti_frame(os.path.join(work, "kitti"), f"{i:06d}", objs,
                          kcalib, left, right)
    save_config(cfg, os.path.join(work, "tiny.json"))
    ck = os.path.join(work, "ckpt")
    final = train_cli.run(train_cli.parse_args([
        "--config", os.path.join(work, "tiny.json"), "--kitti-root",
        os.path.join(work, "kitti"), "--image-ext", ".npy", "--epochs", "1",
        "--batch-per-device", "2", "--ckpt-dir", ck, "--platform", "cpu"]))
    assert final.step == 1
    assert os.path.exists(os.path.join(ck, "config.json"))

    # Serving, calibration, diagnosis, the demo and the upstream import;
    # the demo draws and writes its PNG without an image library.
    for name in ("serving", "convert.norm_calibrate", "convert.resnet_import",
                 "convert.stereo_import", "tools.export_model", "tools.serve",
                 "tools.diag_3d", "tools.calibrate_norm", "tools.demo"):
        importlib.import_module("stereo_rcnn_tpu_torch." + name)
    from stereo_rcnn_tpu_torch.tools import demo
    demo.main(["--synthetic", "--tiny", "--platform", "cpu", "--out",
               os.path.join(work, "demo.png")])
    with open(os.path.join(work, "demo.png"), "rb") as f:
        assert f.read(4)[1:] == b"PNG"
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    print("OK", int(valid.sum()))
""")


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("OK")
