"""The port's command-line tools end to end on the CPU (``--platform
cpu``): the twins of ``tests/test_cli_e2e.py`` and ``tests/test_preempt.py``.

``tools.train`` on a rendered 10-frame ``.npy`` KITTI tree at batch 4 (two
full batches and a wrap-padded tail of 2: 3 steps), then ``tools.test_net``
on the tree with the run's params export and ``tools.eval_synth`` on its
checkpoint, all in this process through ``main(argv)``; then a
subprocess trainer stopped by SIGTERM (rc 75, a checkpoint at the current
step) and resumed in the middle of an epoch.
"""

import os
import select
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from stereo_rcnn_tpu_torch.config import load_config
from stereo_rcnn_tpu_torch.data.synthetic import (random_scene, render_pair,
                                                  write_kitti_frame)
from stereo_rcnn_tpu_torch.geometry.calib import default_kitti_calib
from stereo_rcnn_tpu_torch.tools import eval_synth, test_net, train
from stereo_rcnn_tpu_torch.train.checkpoint import PARAMS_FILE, latest_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 10


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_cli"))
    calib = default_kitti_calib()
    rng = np.random.RandomState(7)
    for i in range(N_FRAMES):
        objs = random_scene(rng, 3, calib, 375, 1242)
        left, right = render_pair(objs, calib, 375, 1242, rng)
        write_kitti_frame(root, f"{i:06d}", objs, calib, left, right)
    return root


def test_train_then_eval_cli(kitti_root, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "results")

    assert train.main([
        "--tiny", "--kitti-root", kitti_root, "--epochs", "1",
        "--batch-per-device", "4", "--ckpt-dir", ckpt, "--image-ext", ".npy",
        "--platform", "cpu", "--disp-interval", "1"]) == 0
    stdout = capsys.readouterr().out
    assert "checkpoint saved" in stdout
    # 10 frames / batch 4 -> 3 steps (the ragged tail wrap-padded).
    assert "[step 3]" in stdout
    assert latest_step(ckpt) == 3
    cfg = load_config(os.path.join(ckpt, "config.json"))
    assert cfg.train.batch_per_device == 4 and cfg.train.epochs == 1
    assert cfg.data.kitti_root == kitti_root
    assert isinstance(cfg.data.classes, tuple)
    with open(os.path.join(ckpt, "metrics.csv")) as f:
        assert len(f.read().splitlines()) == 4          # header + 3 steps

    assert test_net.main([
        "--tiny", "--kitti-root", kitti_root, "--ckpt-dir", ckpt, "--out",
        out, "--batch", "4", "--image-ext", ".npy",
        "--platform", "cpu"]) == 0
    stdout = capsys.readouterr().out
    assert f"{N_FRAMES} frames" in stdout
    assert "loaded checkpoint" in stdout
    assert "AP_3d@0.7 (R40)" in stdout and "AP_bev@0.5 (R11)" in stdout
    # One result file per real frame (the pad replicas are not written),
    # each line devkit-parseable: 16 fields, score last, finite.
    files = sorted(os.listdir(out))
    assert files == [f"{i:06d}.txt" for i in range(N_FRAMES)]
    n_lines = 0
    for fn in files:
        with open(os.path.join(out, fn)) as f:
            for line in f:
                parts = line.split()
                assert len(parts) == 16 and parts[0] == "Car", line
                assert np.isfinite(np.asarray(parts[1:], np.float64)).all()
                n_lines += 1
    assert n_lines > 0

    assert eval_synth.main(["--ckpt-dir", ckpt, "--batches", "1",
                            "--batch", "2", "--platform", "cpu"]) == 0
    stdout = capsys.readouterr().out
    assert "restored step 3 (latest: 3)" in stdout
    assert "2 held-out frames" in stdout
    assert "AP_3d@0.5 (R40)" in stdout and "AP_2d@0.7 (R40)" in stdout


def test_sigterm_checkpoints_then_resumes_mid_epoch(tmp_path, monkeypatch,
                                                    capsys):
    """SIGTERM after a step: rc 75, "preempted at step s", a checkpoint
    and a params export at step s.  Resumed with an epoch of s + 1
    batches, the run skips the s batches already trained and takes one
    step."""
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "stereo_rcnn_tpu_torch.tools.train", "--tiny",
         "--synthetic", "8", "--batch-per-device", "4", "--epochs", "500",
         "--ckpt-dir", ckpt, "--ckpt-every", "1000", "--disp-interval", "1",
         "--platform", "cpu"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, bufsize=1)
    lines = []
    deadline = time.time() + 300
    try:
        stepped = False
        while not stepped:
            if time.time() > deadline:
                raise AssertionError("no training step before the "
                                     "deadline\n" + "".join(lines))
            ready, _, _ = select.select([proc.stdout], [], [], 5.0)
            if not ready:
                continue
            line = proc.stdout.readline()
            if not line:
                raise AssertionError("the trainer exited before stepping\n"
                                     + "".join(lines))
            lines.append(line)
            stepped = line.startswith("[step ")
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
        lines.append(rest)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    full = "".join(lines)
    assert proc.returncode == train.PREEMPTED_RC, full
    assert "preempted at step" in full, full
    saved = latest_step(ckpt)
    assert saved is not None and saved >= 1
    assert f"preempted at step {saved} " in full
    assert os.path.exists(os.path.join(ckpt, "params_export", PARAMS_FILE))

    monkeypatch.chdir(tmp_path)
    handler = signal.getsignal(signal.SIGTERM)
    state = train.run(train.parse_args([
        "--tiny", "--synthetic", str(4 * (saved + 1)), "--batch-per-device",
        "4", "--epochs", "1", "--ckpt-dir", ckpt, "--disp-interval", "1",
        "--platform", "cpu", "--resume"]))
    stdout = capsys.readouterr().out
    assert f"resumed from step {saved}" in stdout
    assert (f"mid-epoch resume: skipping the first {saved} batches of "
            "epoch 1") in stdout
    assert state.step == saved + 1 == latest_step(ckpt)
    # The SIGTERM handler is the caller's own again.
    assert signal.getsignal(signal.SIGTERM) is handler


def test_supervisor_relaunches_and_completes(tmp_path, monkeypatch, capsys):
    """``tools.supervise_train``: a preempted attempt is resumed at once,
    a crash after a backoff, and a run that exits 0 ends the supervision;
    then one real supervised run of the trainer (with ``--resume``
    appended) completes."""
    from stereo_rcnn_tpu_torch.tools import supervise_train
    rcs, launched = [train.PREEMPTED_RC, 1, 0], []
    monkeypatch.setattr(supervise_train, "run_attempt",
                        lambda args, attempt: launched.append(attempt)
                        or rcs[attempt - 1])
    monkeypatch.setattr(supervise_train.time, "sleep", lambda s: None)
    assert supervise_train.main(["--ckpt-dir", "ck", "--backoff", "0",
                                 "--", "--tiny"]) == 0
    out = capsys.readouterr().out
    assert launched == [1, 2, 3]
    assert "preempted with a saved checkpoint; resuming immediately" in out
    assert "ended rc=1; retrying" in out
    assert "training completed" in out
    monkeypatch.undo()

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH",
                       REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ckpt = str(tmp_path / "ckpt")
    assert supervise_train.main([
        "--ckpt-dir", ckpt, "--max-attempts", "1", "--", "--tiny",
        "--synthetic", "4", "--batch-per-device", "4", "--epochs", "1",
        "--ckpt-dir", ckpt, "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "--resume" in out.splitlines()[0]
    assert "epoch 1/1 done, checkpoint saved" in out
    assert latest_step(ckpt) == 1
