"""The port's checkpoints (``train/checkpoint.py``) on the CPU: round trip,
``latest_step``, ``max_to_keep``, the params export, and resume
equivalence.  Every comparison is exact (``torch.equal``): a checkpoint
stores the tensors' bits, and a CPU training step is deterministic.
"""

import copy
import dataclasses
import os

import pytest
import torch

from stereo_rcnn_tpu_torch.config import tiny_test_config
from stereo_rcnn_tpu_torch.data.synthetic import synthetic_batch
from stereo_rcnn_tpu_torch.models.detector import build_model
from stereo_rcnn_tpu_torch.train import (Batch, TrainState,
                                         init_train_state, make_train_step,
                                         step_generator)
from stereo_rcnn_tpu_torch.train.checkpoint import (PARAMS_FILE,
                                                    checkpoint_path,
                                                    export_params,
                                                    latest_step,
                                                    restore_checkpoint,
                                                    restore_params,
                                                    restore_train_state,
                                                    save_checkpoint)


def _cfg():
    base = tiny_test_config()
    return dataclasses.replace(
        base, compute_dtype="float32",
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas"),
        train=dataclasses.replace(base.train, batch_per_device=2))


@pytest.fixture(scope="module")
def trained():
    """A fresh tiny GroupNorm state from ``init_train_state`` (its model
    is ``init_params``'), the same state after one step (so it has
    momentum), the step function and two batches."""
    cfg = _cfg()
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(cfg, steps_per_epoch=10, device="cpu")
    batches = [Batch(*synthetic_batch(cfg, 2, seed=s, n_objects=3)[:3])
               for s in (0, 1)]
    fresh = copy.deepcopy(state)
    step(state, batches[0], step_generator(1, 0, "cpu"))
    return cfg, fresh, state, step, batches


def _assert_same_state(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(a.uncert.detach(), b.uncert.detach())
    assert a.trace.keys() == b.trace.keys() and a.trace
    for k in a.trace:
        assert torch.equal(a.trace[k], b.trace[k]), k


def test_round_trip_and_latest_step(trained, tmp_path):
    cfg, _, state, _, _ = trained
    ck = str(tmp_path / "ck")
    assert latest_step(ck) is None
    assert latest_step(str(tmp_path / "missing" / "dir")) is None
    with pytest.raises(FileNotFoundError):
        restore_train_state(ck, cfg, "cpu")
    save_checkpoint(ck, state)
    assert latest_step(ck) == state.step == 1
    # A file left by a save that was cut off is not a checkpoint.
    open(os.path.join(ck, "ckpt_9.pt.123.tmp"), "wb").close()
    assert latest_step(ck) == 1
    restored = restore_train_state(ck, cfg, "cpu")
    _assert_same_state(restored, state)
    assert restored.uncert.requires_grad
    # restore_checkpoint into a template from init_train_state.
    template = init_train_state(cfg, state_dict=build_model(
        cfg).state_dict(), device="cpu")
    _assert_same_state(restore_checkpoint(ck, template, step=1), state)


def test_max_to_keep(tmp_path):
    ck = str(tmp_path / "ck")
    keep = TrainState(step=0, model=torch.nn.Linear(3, 2),
                      uncert=torch.zeros(6), trace={})
    for s in range(1, 8):
        keep.step = s
        save_checkpoint(ck, keep, max_to_keep=5)
    assert sorted(os.listdir(ck)) == sorted(
        os.path.basename(checkpoint_path(ck, s)) for s in range(3, 8))
    assert latest_step(ck) == 7


def test_params_export_round_trip_and_refusal(trained, tmp_path):
    """The export loads into a fresh ``init_params`` model (the fixture's
    untrained one) with ``strict=True``, and a model of another tree
    refuses it."""
    cfg, fresh_state, state, _, _ = trained
    ex = str(tmp_path / "params_export")
    export_params(ex, state.model)
    assert os.listdir(ex) == [PARAMS_FILE]
    fresh = copy.deepcopy(fresh_state.model)
    restore_params(ex, fresh)
    want = state.model.state_dict()
    got = fresh.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    other = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, norm="frozen"))
    with pytest.raises(RuntimeError):
        restore_params(ex, build_model(other))
    wider = dataclasses.replace(cfg, rcnn=dataclasses.replace(
        cfg.rcnn, fc_dim=cfg.rcnn.fc_dim // 2))
    with pytest.raises(RuntimeError, match="size mismatch"):
        restore_params(ex, build_model(wider))


def test_resume_equals_an_uninterrupted_run(trained, tmp_path):
    """Two steps straight equal one step, a checkpoint, a restore into a
    fresh template and one more step: parameters, momentum, uncertainty
    weights and the second step's metrics, bit for bit.  Each step's
    target sampling draws from ``step_generator(seed, step)``, so the
    resumed run replays the uninterrupted run's uniforms."""
    cfg, fresh, _, step, batches = trained
    straight, split = copy.deepcopy(fresh), copy.deepcopy(fresh)
    metrics = []
    for i, b in enumerate(batches):
        metrics.append(step(straight, b, step_generator(1, i, "cpu")))
    step(split, batches[0], step_generator(1, 0, "cpu"))
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, split)
    resumed = restore_train_state(ck, cfg, "cpu")
    m2 = step(resumed, batches[1], step_generator(1, resumed.step, "cpu"))
    _assert_same_state(resumed, straight)
    assert resumed.step == 2
    assert m2.keys() == metrics[1].keys()
    for k in m2:
        assert torch.equal(m2[k], metrics[1][k]), k
