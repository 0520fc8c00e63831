"""The port runs where JAX cannot be imported.

A subprocess installs a ``sys.meta_path`` finder that refuses ``jax``,
``flax``, ``optax``, ``orbax`` and ``yaml``, imports the port, builds the
tiny frozen-BN config and runs ``make_full_pipeline`` once on the CPU,
then one training step of the tiny GroupNorm config (``train/``,
``data/kitti.py`` and the RoIAlign autograd Function), as the card's
machine (which has no JAX) must.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib.abc
    import sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml")

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

    base = srt.tiny_test_config()
    cfg = dataclasses.replace(
        base, compute_dtype="float32",
        backbone=dataclasses.replace(base.backbone, norm="frozen"),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas"))
    model = srt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    il, ir, calib = srt.synthetic_images(cfg, 1, seed=7, n_objects=2)
    out = srt.make_full_pipeline(cfg, calib)(model, torch.from_numpy(il),
                                              torch.from_numpy(ir))
    d = cfg.rcnn.max_detections
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
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    print("OK", int(valid.sum()))
""")


def test_port_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("OK")
