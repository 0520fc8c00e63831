"""The port's serving path on the CPU: ``serving.export_pipeline`` and
``load_pipeline`` (a ``torch.export`` artifact), the twin of
``tests/test_serving.py`` (the CLIs: ``tests/test_torch_serve_cli.py``).

One export of the tiny frozen-BN config in float32 with the fused RoIAlign
(``roi_align_impl="pallas"``, batch 2), its weights from a JAX
initialisation through ``convert.from_jax`` with
``tests/test_torch_pipeline.py``'s output-layer scalings, serves the
module's tests.  Tolerances: the artifact against the
live port pipeline exactly (the same ops on the same CPU); against the
JAX artifact (``stereo_rcnn_tpu.serving``, its Pallas kernel in interpret
mode), ``test_torch_pipeline.py``'s for 2D detections: validity exact,
boxes and scores 1e-3.
"""

import io
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu import inference as j_inf
from stereo_rcnn_tpu import serving as j_serving
from stereo_rcnn_tpu.config import tiny_test_config as j_tiny
from stereo_rcnn_tpu.geometry.calib import StereoCalib as JStereoCalib
from stereo_rcnn_tpu.models import detector as j_det
from stereo_rcnn_tpu_torch import serving
from stereo_rcnn_tpu_torch.config import tiny_test_config
from stereo_rcnn_tpu_torch.convert.from_jax import state_dict_from_jax
from stereo_rcnn_tpu_torch.data.synthetic import synthetic_images
from stereo_rcnn_tpu_torch.inference import (broadcast_calib,
                                             make_full_pipeline)
from stereo_rcnn_tpu_torch.models.detector import init_params
from stereo_rcnn_tpu_torch.ops import stereo_roi_align as t_sra
from stereo_rcnn_tpu_torch.solve import box_estimator as t_box
from stereo_rcnn_tpu_torch.utils import device_constants

from tests.test_torch_pipeline import (BOX_SCALE, CLS_SCALE, RPN_BOX_SCALE,
                                       RPN_SCALE, _parity_cfg)

BATCH = 2
OP = torch.ops.stereo_rcnn_tpu_torch.stereo_roi_align_fwd.default
SOLVE_OP = torch.ops.stereo_rcnn_tpu_torch.gauss_newton_solve.default


@pytest.fixture(scope="module")
def exported():
    cfg_j = _parity_cfg(j_tiny())
    cfg = _parity_cfg(tiny_test_config())
    params = jax.tree.map(np.array, j_det.init_params(cfg_j,
                                                      jax.random.PRNGKey(0)))
    p = params["params"]
    p["rcnn_head"]["cls_score"]["kernel"] *= CLS_SCALE
    p["rpn_head"]["rpn_cls"]["kernel"] *= RPN_SCALE
    p["rpn_head"]["rpn_box"]["kernel"] *= RPN_BOX_SCALE
    p["rcnn_head"]["bbox_pred"]["kernel"] *= BOX_SCALE
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    # The trace meets an empty constant cache: each lookup misses.
    device_constants.clear()
    builds = device_constants.counts()
    blob = serving.export_pipeline(cfg, model, BATCH)
    kept_after_export = list(device_constants._CACHE.values())
    il, ir, calib = synthetic_images(cfg, BATCH, seed=5, n_objects=2)
    return dict(cfg=cfg, cfg_j=cfg_j, params=params, model=model, blob=blob,
                pipe=serving.load_pipeline(blob), il=il, ir=ir, calib=calib,
                builds=builds, kept_after_export=kept_after_export)


def _run(pipe_or_model, ex):
    args = (torch.from_numpy(ex["il"]), torch.from_numpy(ex["ir"]),
            broadcast_calib(ex["calib"], BATCH, "cpu"))
    if isinstance(pipe_or_model, serving.ExportedPipeline):
        return pipe_or_model(*args)
    return make_full_pipeline(ex["cfg"])(pipe_or_model, *args)


def _assert_equal(served, live):
    for name, a, b in zip(served.det._fields, served.det, live.det):
        assert torch.equal(a, b), name
    for name in ("position", "ry", "z_refined", "residual"):
        assert torch.equal(getattr(served, name), getattr(live, name)), name


def test_round_trip_equals_live_pipeline(exported):
    pipe, cfg = exported["pipe"], exported["cfg"]
    m = pipe.manifest
    assert m["batch"] == BATCH and m["device"] == "cpu"
    assert m["image_hw"] == [cfg.data.image_h, cfg.data.image_w]
    assert m["num_params"] == sum(
        t.numel() for t in exported["model"].state_dict().values())
    live = _run(exported["model"], exported)
    served = _run(pipe, exported)
    assert live.det.valid.sum() > 0
    _assert_equal(served, live)


def test_export_keeps_no_fake_constant(exported):
    """The trace's misses of the constant cache (anchors, ``mean_dims``,
    ``stds``) build fake tensors, which the cache hands out but never
    keeps; eager calls after it build and keep real ones, and give the
    artifact's outputs."""
    assert exported["kept_after_export"] == []
    live = _run(exported["model"], exported)
    kept = [t for t, _ in device_constants._CACHE.values()]
    assert kept and all(type(t) is torch.Tensor and t.device.type == "cpu"
                        for t in kept)
    assert device_constants.counts()["anchors"].builds > exported[
        "builds"].get("anchors", (0, 0))[0]
    _assert_equal(_run(exported["pipe"], exported), live)


@pytest.mark.parametrize("op", ["roi_align", "solve"])
def test_exported_graph_holds_the_fused_roi_align_op(exported, monkeypatch,
                                                     op):
    """The registered ops as graph nodes (no decomposed RoIAlign, no
    unrolled solver loop), which on CPU tensors call their plain versions,
    looked up at each call: one node of the fused RoIAlign; two of the
    Gauss-Newton solve, the solve and the z-fixed re-solve (the second
    with ``fixed_z``).  No node of the profiler (the stage spans are off
    while the export traces)."""
    graph = exported["pipe"].module.graph
    target, module, plain, count = {
        "roi_align": (OP, t_sra, "stereo_roi_align_packed_ref", 1),
        "solve": (SOLVE_OP, t_box, "solve_batch_ref", 2)}[op]
    nodes = [n for n in graph.nodes
             if n.op == "call_function" and n.target == target]
    assert len(nodes) == count
    assert not [n for n in graph.nodes if "profiler" in str(n.target)]
    if op == "roi_align":
        assert nodes[0].args[5] == "f32"
    else:
        assert [n.args[10] is None for n in nodes] == [True, False]
    calls = []
    ref = getattr(module, plain)
    monkeypatch.setattr(module, plain,
                        lambda *a: calls.append(1) or ref(*a))
    _run(exported["pipe"], exported)
    assert len(calls) == count


def test_load_state_dict_swaps_the_weights(exported):
    """Weights are a run-time input: other weights loaded over the
    artifact's give the live pipeline's result with those weights; a
    state_dict with a name the model lacks is refused."""
    pipe, cfg = exported["pipe"], exported["cfg"]
    other = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    try:
        pipe.load_state_dict(other.state_dict())
        _assert_equal(_run(pipe, exported), _run(other, exported))
        with pytest.raises(RuntimeError, match="bogus"):
            pipe.load_state_dict({**other.state_dict(),
                                  "bogus": torch.zeros(1)})
    finally:
        pipe.load_state_dict(exported["model"].state_dict())
    _assert_equal(_run(pipe, exported), _run(exported["model"], exported))


def _zip(files):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, data in files.items():
            zf.writestr(name, data)
    return buf.getvalue()


@pytest.mark.parametrize("blob", [
    b"\x05\x00\x00\x00hello" + b"x" * 100,
    b"",
    _zip({"archive/data.pkl": b"x"}),
    _zip({"archive/extra/manifest.json":
          json.dumps({"format": "stereo_rcnn_tpu.manifest"})}),
    _zip({"archive/extra/manifest.json": b"\xff not json"}),
], ids=["garbage", "empty", "zip-without-manifest", "jax-manifest",
        "bad-json"])
def test_load_pipeline_rejects_garbage(blob):
    with pytest.raises(ValueError):
        serving.load_pipeline(blob)


def test_artifact_agrees_with_jax_artifact(exported):
    """The JAX artifact of the same config and weights, on the same
    images: 2D detections to test_torch_pipeline.py's tolerances."""
    jparams = jax.tree.map(jnp.asarray, exported["params"])
    j_pipe = j_serving.load_pipeline(j_serving.export_pipeline(
        exported["cfg_j"], jparams, BATCH, platforms=("cpu",)))
    theirs = j_pipe(jparams, jnp.asarray(exported["il"]),
                    jnp.asarray(exported["ir"]),
                    j_inf.broadcast_calib(JStereoCalib(*exported["calib"]),
                                          BATCH))
    ours = _run(exported["pipe"], exported)
    valid = np.asarray(theirs.det.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(ours.det.valid.numpy(), valid)
    for name in ("box_left", "box_right", "score"):
        np.testing.assert_allclose(getattr(ours.det, name).numpy(),
                                   np.asarray(getattr(theirs.det, name)),
                                   atol=1e-3, err_msg=name)
