"""The port's data parallelism (``stereo_rcnn_tpu_torch.parallel``) on the
CPU: the twins of ``tests/test_sharding.py``, with two gloo ranks.

One spawned run of two ranks (``tests/torch_dp_worker.py``, port only)
forms the mesh, takes one data-parallel training step and runs the
sharded inference pipeline, at the tiny config in float32 with the fused
RoIAlign (its plain versions on the CPU) and frozen norms.  While it runs,
this process computes the references: the port's single-process step at
the same global batch, JAX's single-device ``make_train_step`` (its
uniforms replayed into both ports' target sampling, as
``tests/test_torch_train.py`` does) and JAX's single-device
``make_full_pipeline``.  JAX's sharded path is not the reference: its
inference test fails.  Apart, ``parallel.launch.spawn`` is checked on
ranks that report their environment, and ``make_mesh``'s size checks in
this process.

Tolerances: against the single-process step, the loss 1e-5 relative and
the updated ``fc6`` 2e-5 absolute (the same step, its gradient a mean of
two per-image means in place of one two-image mean); against JAX,
``tests/test_torch_train.py``'s (metrics 1e-4 relative, updates 2e-3 of
their largest magnitude plus an ulp of the parameter) and
``tests/test_sharding.py``'s (``valid`` exactly, boxes 1e-3, positions
1e-2 m where the JAX solve is stable under a 1e-5 px shift of the boxes,
as ``tests/test_torch_pipeline.py`` holds them).
"""


import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu import inference as j_inf
from stereo_rcnn_tpu import train as j_train
from stereo_rcnn_tpu.config import tiny_test_config as j_tiny
from stereo_rcnn_tpu.data.synthetic import synthetic_batch as j_synthetic
from stereo_rcnn_tpu_torch.config import tiny_test_config
from stereo_rcnn_tpu_torch.convert.from_jax import state_dict_from_jax
from stereo_rcnn_tpu_torch.geometry.anchors import generate_anchors
from stereo_rcnn_tpu_torch.geometry.calib import StereoCalib
from stereo_rcnn_tpu_torch.parallel import make_mesh
from stereo_rcnn_tpu_torch.parallel.launch import spawn
from stereo_rcnn_tpu_torch.train import (Batch, init_train_state,
                                         make_train_step)
from stereo_rcnn_tpu_torch.train.losses import LOSS_NAMES
from stereo_rcnn_tpu_torch.train.step import trainable_params
from stereo_rcnn_tpu_torch.train.targets import ground_truth_to_torch
from tests import torch_dp_worker
from tests.test_torch_train import (STEPS_PER_EPOCH, _batch_np, _cfg,
                                    _jax_state, jax_uniforms)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

WATCHED = ("rcnn_head.RCNN_fc6.weight",
           "backbone_net.RCNN_layer4.0.conv2.weight", "uncert")


# ``tests/test_torch_pipeline.py``'s weights for inference: the training
# state's (the same initialisation, its RPN already scaled) with the class
# scores saturated and the box deltas O(0.5).
INFER_SCALE = {"rcnn_head.RCNN_cls_score.weight": 300.0,
               "rcnn_head.RCNN_bbox_pred.weight": 0.1}


def _infer_params(params):
    p = jax.tree.map(np.array, params["model"])
    p["rcnn_head"]["cls_score"]["kernel"] *= np.float32(300.0)
    p["rcnn_head"]["bbox_pred"]["kernel"] *= np.float32(0.1)
    return {"params": p}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    cfg_j = _cfg(j_tiny(), "frozen")
    cfg = _cfg(tiny_test_config(), "frozen")
    params, state_j = _jax_state(cfg_j)
    il, ir, gt = _batch_np(cfg_j)
    key = jax.random.PRNGKey(3)
    h, w = cfg.data.image_h, cfg.data.image_w
    a = generate_anchors(cfg.anchors, h, w, cfg.box_off, "cpu").shape[0]
    n = cfg.rpn.train_post_nms_top_n + cfg.train.max_gt_boxes
    uniforms = jax_uniforms(key, 2, a, n)
    train_sd = state_dict_from_jax(params, cfg)
    params_inf = _infer_params(params)
    il2, ir2, _, calib = j_synthetic(cfg_j, batch=2, seed=7, n_objects=3)
    calib_b = j_inf.broadcast_calib(calib, 2)
    calib_t = StereoCalib(*[torch.from_numpy(np.array(x)) for x in calib_b])
    inputs = str(tmp / "inputs.pt")
    torch.save({"cfg": cfg, "train_sd": train_sd,
                "infer_scale": INFER_SCALE, "watched": WATCHED,
                "batch": (il, ir, gt), "uniforms": uniforms,
                "steps_per_epoch": STEPS_PER_EPOCH,
                "infer_inputs": (torch.from_numpy(il2), torch.from_numpy(ir2),
                                 calib_t)}, inputs)

    # The two ranks run while this process computes the references.
    codes = []
    ranks = threading.Thread(target=lambda: codes.extend(spawn(
        torch_dp_worker.rank_main, 2, inputs, str(tmp), timeout=600)))
    ranks.start()
    try:
        state = init_train_state(cfg, state_dict=train_sd, device="cpu")
        before = {k: v.detach().clone()
                  for k, v in trainable_params(state).items()}
        metrics = make_train_step(cfg, STEPS_PER_EPOCH, device="cpu")(
            state, Batch(torch.from_numpy(il), torch.from_numpy(ir),
                         ground_truth_to_torch(gt, "cpu")),
            uniforms=uniforms)
        single = ({k: float(v) for k, v in metrics.items()},
                  {k: trainable_params(state)[k].detach().clone()
                   for k in WATCHED})
        before = {k: before[k] for k in WATCHED}
        batch_j = j_train.Batch(jnp.asarray(il), jnp.asarray(ir),
                                jax.tree.map(jnp.asarray, gt))
        new_j, metrics_j = jax.jit(j_train.make_train_step(
            cfg_j, STEPS_PER_EPOCH))(state_j, batch_j, key)
        after_j = state_dict_from_jax(jax.tree.map(np.asarray,
                                                   new_j.params), cfg)
        jparams = jax.tree.map(jnp.asarray, params_inf)
        full = jax.jit(j_inf.make_full_pipeline(cfg_j))(jparams, il2, ir2,
                                                        calib_b)
        solve = jax.jit(lambda d_, l, r, c: j_inf.solve_and_align(
            d_, l, r, c, cfg_j))
        move = 0.0
        for eps in (1e-5, -1e-5):
            det_ = full.det
            shifted = solve(det_._replace(box_left=det_.box_left + eps,
                                          box_right=det_.box_right - eps),
                            il2, ir2, calib_b)
            move = np.maximum(move, np.abs(np.asarray(shifted.position) -
                                           np.asarray(full.position)
                                           ).max(-1))
        stable = np.asarray(full.det.valid) & (move < 1e-2)
    finally:
        ranks.join()
    assert codes == [0, 0], codes
    ranks_out = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    return dict(ranks=ranks_out, single=single, before=before,
                metrics_j=metrics_j, after_j=after_j, full=full,
                stable=stable)


def test_mesh_spans_the_ranks(dp):
    """Two ranks form a 2 x 1 mesh; ``model_parallel=2`` on them gives a
    data axis of 1 (``make_mesh``'s ``n % model_parallel`` rule)."""
    for r, out in enumerate(dp["ranks"]):
        assert out["mesh"] == (2, r, 2, r, 0, "gloo")
        assert out["mesh_mp2"] == (1, 0, r)


def test_make_mesh_checks_sizes():
    """A process alone is a group of one: ``n_devices`` must match it and
    ``model_parallel`` divide it, before any group is formed."""
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(model_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="n_devices=2"):
        make_mesh(2, device="cpu")
    with make_mesh(device="cpu") as mesh:
        assert (mesh.world_size, mesh.data_size, mesh.backend) == (
            1, 1, "gloo")
    assert not torch.distributed.is_initialized()


def test_batch_sharding_layout(dp):
    """Each rank holds exactly its row of a batch of 2."""
    x = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
    for r, out in enumerate(dp["ranks"]):
        rows, sl = out["rows"]
        assert rows.shape == (1, 4, 4, 3)
        np.testing.assert_array_equal(rows, x[r:r + 1])
        assert sl == slice(r, r + 1)


def test_data_parallel_step_matches_single_process(dp):
    """Both ranks take the same step, and it is the single-process step
    at the global batch (the gradient all-reduce == the batch mean)."""
    (m1, p1), (r0, r1) = dp["single"], dp["ranks"]
    assert r0["digest"] == r1["digest"]
    assert r0["metrics"] == r1["metrics"]
    np.testing.assert_allclose(r0["metrics"]["total"], m1["total"],
                               rtol=1e-5)
    for k in LOSS_NAMES:
        np.testing.assert_allclose(r0["metrics"][k], m1[k], rtol=1e-5,
                                   err_msg=k)
    name = "rcnn_head.RCNN_fc6.weight"
    assert not torch.equal(r0["params"][name], dp["before"][name])
    torch.testing.assert_close(r0["params"][name], p1[name], atol=2e-5,
                               rtol=0)


def test_data_parallel_step_matches_jax(dp):
    """The two-rank step against JAX's single-device step on the global
    batch: every metric, and the updates of the fc6 kernel, a layer4
    kernel (reached only through the RoIAlign backward) and the
    uncertainty weights."""
    m, mj = dp["ranks"][0]["metrics"], dp["metrics_j"]
    assert float(mj["num_fg_rcnn"]) > 0
    assert set(m) == set(mj)
    for k in (*LOSS_NAMES, "total", "grad_norm", "num_fg_rpn",
              "num_fg_rcnn", "lr"):
        np.testing.assert_allclose(m[k], float(mj[k]), rtol=1e-4,
                                   err_msg=k)
    for name in WATCHED:
        before = dp["before"][name].numpy()
        ours = dp["ranks"][0]["params"][name].numpy() - before
        theirs = dp["after_j"][name].numpy() - before
        scale = float(np.abs(theirs).max())
        assert scale > 0.0, name
        excess = np.abs(ours - theirs) - (2e-3 * scale +
                                          np.spacing(np.abs(before)))
        assert excess.max() <= 0.0, (name, float(np.abs(ours - theirs).max()),
                                     scale)


def test_sharded_inference_matches_jax(dp):
    """Each rank's gathered detections (rank order = row order) against
    JAX's single-device pipeline on the global batch."""
    full, stable = dp["full"], dp["stable"]
    d0, d1 = dp["ranks"][0]["det"], dp["ranks"][1]["det"]
    for a, b in zip(jax.tree.leaves(tuple(d0)), jax.tree.leaves(tuple(d1))):
        assert torch.equal(a, b)
    valid = np.asarray(full.det.valid)
    assert d0.position.shape == full.position.shape
    np.testing.assert_array_equal(d0.det.valid.numpy(), valid)
    assert valid.sum() > 0 and stable.sum() * 2 >= valid.sum()
    np.testing.assert_allclose(d0.det.box_left.numpy(),
                               np.asarray(full.det.box_left), atol=1e-3)
    assert np.isfinite(d0.position.numpy()[valid]).all()
    np.testing.assert_allclose(d0.position.numpy()[stable],
                               np.asarray(full.position)[stable], atol=1e-2)


def test_spawn_sets_the_rank_environment_and_ends_stragglers(tmp_path,
                                                             monkeypatch):
    """``parallel.launch.spawn`` starts each rank with torchrun's
    variables and returns the exit codes in rank order; once a rank has
    failed, one still running after the grace period is killed."""
    from stereo_rcnn_tpu_torch.parallel import launch
    from stereo_rcnn_tpu_torch.tools.train import PREEMPTED_RC, exit_code
    monkeypatch.setattr(launch, "GRACE_S", 2.0)
    codes = launch.spawn(torch_dp_worker.report_env, 3, str(tmp_path), 0,
                         timeout=120)
    assert codes == [-9, 1, 2]
    for r in range(3):
        assert (tmp_path / f"env{r}").read_text() == f"{r} {r} 3 127.0.0.1"
    assert exit_code(codes) == 1
    assert exit_code([0, 0]) == 0
    assert exit_code([PREEMPTED_RC, 0]) == PREEMPTED_RC
    assert exit_code([PREEMPTED_RC, 3]) == 3
