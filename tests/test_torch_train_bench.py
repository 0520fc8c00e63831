"""The training cell of the benchmark on the CPU: the port's training step
against the benchmark's plain float32 reference step
(``h100_bench/reference/train/``), the hand-back of a step's proposals,
the cell's files and its per-layer readers.

The port runs ``make_train_step`` at the tiny configuration in float32
with the fused RoIAlign's plain version; the reference repeats the step
from the same weights, momentum, batch and uniforms on the port's
proposals.  Both then do the same float32 arithmetic in other orders
(per-image blocks against the whole batch, autograd's RoIAlign gradient
against the port's written-out one), so they agree to a few float32
roundings, far inside what a bf16 step would give (0.4 % a rounding).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from h100_bench import harness
from h100_bench.compare.train import compare_step
from h100_bench.drivers.train_loop import (render_train_pool, uniforms_of)
from h100_bench.reference.config import load_config as ref_load_config
from h100_bench.reference.train.step import Batch, reference_step
from h100_bench.reference.train.targets import GroundTruth
from h100_bench.reference.train.weights import training_state_dict
from stereo_rcnn_tpu_torch.config import (synthetic_fullres_config,
                                          tiny_test_config)
from stereo_rcnn_tpu_torch.train import step as port_step
from stereo_rcnn_tpu_torch.train import targets as port_targets
from tests.torch_threads import one_torch_thread  # noqa: F401

B = 2
SEED = 2**31 + 4099
#: Per-leaf gradient gap, ``|g_port - g_ref| / |g_ref|``: float32 sums in
#: other orders (1e-6 to 3e-6 read); a bf16 rounding is 4e-3.
GRAD_REL = 1e-4
#: Relative gap of each loss: the same float32 operations, the batch mean
#: taken as a sum over blocks (0 to 1e-7 read).
LOSS_REL = 1e-5
#: ``|dp_port - dp_ref| / |dp_ref|`` of the whole update (every leaf's
#: change, concatenated) and of each leaf's momentum: the gradients' gaps,
#: and each updated weight rounded to float32 (~1e-5 read).  One leaf's
#: update alone is no test: a GroupNorm scale near 1 moves by ~1e-6, a
#: few float32 roundings of the weight.
UPDATE_REL = 1e-4
#: Each updated leaf, ``|p_port - p_ref| / |p_ref|``: a float32 rounding,
#: or, for a leaf that starts at 0 (biases), its update's gap, which is
#: its gradient's.
PARAM_REL = GRAD_REL


def _tiny():
    """The tiny configuration in float32 with the fused RoIAlign, narrowed
    (FPN 32, RPN conv 64, fc 128) so that a step takes about a second."""
    base = tiny_test_config()
    return dataclasses.replace(
        base, compute_dtype="float32",
        backbone=dataclasses.replace(base.backbone, fpn_dim=32),
        rpn=dataclasses.replace(base.rpn, conv_dim=64),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas",
                                 fc_dim=128),
        train=dataclasses.replace(base.train, batch_per_device=B))


def _lists(x):
    if isinstance(x, dict):
        return {k: _lists(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_lists(v) for v in x]
    return x


@pytest.fixture(scope="module")
def stepped():
    """One port step from seeded weights and a seeded momentum, recorded,
    and the reference's repeat of it (blocks of one image)."""
    torch.manual_seed(0)
    cfg = _tiny()
    rcfg = ref_load_config(None, overrides=_lists(dataclasses.asdict(cfg)))
    left, right, gt = render_train_pool(rcfg, B, 3, SEED, threads=1)
    sd = training_state_dict(rcfg, SEED, "cpu")
    state = port_step.init_train_state(cfg, state_dict=sd, device="cpu")
    gen = torch.Generator().manual_seed(5)
    state.trace = {n: 1e-3 * torch.randn(p.shape, generator=gen)
                   for n, p in port_step.trainable_params(state).items()}
    state.step = 3
    before = {**{k: v.clone() for k, v in state.model.state_dict().items()},
              "uncert": state.uncert.detach().clone()}
    trace0 = {k: v.clone() for k, v in state.trace.items()}
    uniforms = uniforms_of(rcfg, 11, 3, B, "cpu")
    gt_t = [torch.from_numpy(np.ascontiguousarray(x)) for x in gt]
    batch = port_step.Batch(torch.from_numpy(left), torch.from_numpy(right),
                            port_targets.GroundTruth(*gt_t))
    step_fn = port_step.make_train_step(cfg, 4, device="cpu")
    ev = {}
    metrics = step_fn(state, batch,
                      uniforms=port_targets.Uniforms(*uniforms), evidence=ev)
    params = port_step.trainable_params(state)
    rbatch = Batch(batch.images_left, batch.images_right,
                   GroundTruth(*gt_t))
    ref = reference_step(rcfg, before, trace0, 3, rbatch, uniforms, 4,
                         proposals={k: ev[k] for k in ("left", "right",
                                                       "valid")})
    return dict(cfg=cfg, rcfg=rcfg, before=before, trace0=trace0,
                uniforms=uniforms, batch=rbatch, ev=ev, metrics=metrics,
                grads={n: p.grad.clone() for n, p in params.items()},
                after={**{k: v.clone() for k, v in
                          state.model.state_dict().items()},
                       "uncert": state.uncert.detach().clone()},
                trace={k: v.clone() for k, v in state.trace.items()},
                ref=ref)


def _rel(a, b):
    return float((a.double() - b.double()).norm() /
                 b.double().norm().clamp(min=1e-30))


def _update(after, before):
    return torch.cat([(after[n].double() - before[n].double()).reshape(-1)
                      for n in sorted(before)])


def test_step_parity_with_the_reference(stepped):
    s, ref = stepped, stepped["ref"]
    for k in ref.losses:
        assert _rel(s["metrics"][k], ref.losses[k]) <= LOSS_REL, k
    assert torch.equal(s["ev"]["num_fg_rpn"], ref.num_fg_rpn)
    assert torch.equal(s["ev"]["num_fg_rcnn"], ref.num_fg_rcnn)
    assert set(s["grads"]) == set(ref.grads)
    gaps = {n: _rel(s["grads"][n], ref.grads[n]) for n in ref.grads}
    assert max(gaps.values()) <= GRAD_REL, max(gaps, key=gaps.get)
    assert _rel(s["metrics"]["grad_norm"], ref.g_norm) <= GRAD_REL
    assert set(s["after"]) == set(ref.params)
    for n in ref.params:
        assert _rel(s["after"][n], ref.params[n]) <= PARAM_REL, n
    assert _rel(_update(s["after"], s["before"]),
                _update(ref.params, s["before"])) <= UPDATE_REL
    assert set(s["trace"]) == set(ref.trace)
    for n in ref.trace:
        assert _rel(s["trace"][n], ref.trace[n]) <= UPDATE_REL, n


def test_compare_step_reads_the_parity(stepped):
    """The cell's check reads a sound float32 step as near 0."""
    from h100_bench.compare.train import Record
    s = stepped
    rec = Record(count=3, params=s["before"], trace=s["trace0"],
                 batch=s["batch"], uniforms=s["uniforms"],
                 proposals={k: s["ev"][k] for k in ("left", "right",
                                                    "valid")},
                 losses={k: s["metrics"][k] for k in s["ref"].losses},
                 num_fg_rpn=s["ev"]["num_fg_rpn"],
                 num_fg_rcnn=s["ev"]["num_fg_rcnn"], grads=s["grads"],
                 g_norm=s["metrics"]["grad_norm"], after=s["after"])
    got = compare_step(s["rcfg"], rec, s["ref"])
    assert got["target_mismatch"] == 0
    assert got["loss_rel"] <= LOSS_REL
    assert got["grad_rel_p90"] <= got["grad_rel_max"] <= GRAD_REL
    assert got["update_rel"] <= UPDATE_REL
    assert got["leaves"] == len(s["ref"].grads)


def test_reference_blocks_equal_its_whole_batch_step(stepped):
    """Per-image blocks and the whole batch at once: the same gradient,
    summed in another order."""
    s, one = stepped, stepped["ref"]
    whole = reference_step(s["rcfg"], s["before"], s["trace0"], 3,
                           s["batch"], s["uniforms"], 4,
                           proposals=one.proposals, block=B)
    for k in one.losses:
        assert _rel(whole.losses[k], one.losses[k]) <= LOSS_REL, k
    assert torch.equal(whole.num_fg_rcnn, one.num_fg_rcnn)
    for n in one.grads:
        assert _rel(whole.grads[n], one.grads[n]) <= GRAD_REL, n
    for n in one.params:
        assert _rel(whole.params[n], one.params[n]) <= PARAM_REL, n
    assert _rel(_update(whole.params, s["before"]),
                _update(one.params, s["before"])) <= UPDATE_REL


def test_handing_back_the_proposals_changes_no_loss(stepped):
    """``compute_losses(..., evidence=...)`` gives the same bits, and the
    proposals it hands back are the ones its targets were sampled from."""
    s = stepped
    cfg = s["cfg"]
    model = port_step.build_model(cfg)
    model.load_state_dict({k: v for k, v in s["before"].items()
                           if k != "uncert"})
    b = s["batch"]
    batch = port_step.Batch(b.left, b.right,
                            port_targets.GroundTruth(*b.gt))
    u = port_targets.Uniforms(*s["uniforms"])
    with torch.no_grad():
        plain = port_step.compute_losses(model, batch, cfg, uniforms=u)
        ev = {}
        handed = port_step.compute_losses(model, batch, cfg, uniforms=u,
                                          evidence=ev)
    assert set(plain) == set(handed)
    for k in plain:
        assert plain[k].numpy().tobytes() == handed[k].numpy().tobytes(), k
    assert set(ev) == {"left", "right", "valid", "num_fg_rpn",
                       "num_fg_rcnn", "anchor_weights", "rois_left",
                       "roi_weights"}
    assert ev["left"].shape == (B, cfg.rpn.train_post_nms_top_n, 4)
    assert ev["valid"].dtype == torch.bool and not ev["left"].requires_grad
    assert float(ev["num_fg_rcnn"].float().mean()) == float(
        plain["num_fg_rcnn"])


def test_rendered_ground_truth_is_the_ports():
    """The benchmark's frozen annotation rules pack what the port's
    ``data.kitti`` packs for the same scene."""
    from h100_bench.inputs import POOL, sub_seed, working_calib
    from h100_bench.reference.data.synthetic import random_scene
    from stereo_rcnn_tpu_torch.data.kitti import (annotations_for_frame,
                                                  pack_ground_truth)
    from stereo_rcnn_tpu_torch.data.synthetic import (random_scene as
                                                      port_scene)
    cfg = _tiny()
    rcfg = ref_load_config(None, overrides=_lists(dataclasses.asdict(cfg)))
    _, _, gt = render_train_pool(rcfg, 2, 5, SEED, threads=1)
    calib = working_calib(rcfg)
    for i in range(2):
        rng = np.random.RandomState(sub_seed(SEED, POOL, i) % (1 << 32))
        objs = random_scene(rng, 5, calib, 128, 256, ("Car",))
        rng = np.random.RandomState(sub_seed(SEED, POOL, i) % (1 << 32))
        assert len(port_scene(rng, 5, calib, 128, 256, ("Car",))) == len(
            objs)
        want = pack_ground_truth(annotations_for_frame(
            objs, calib, 256.0, cfg.data), cfg.train.max_gt_boxes)
        for name, a, b in zip(GroundTruth._fields, want, gt):
            np.testing.assert_array_equal(np.asarray(a, b.dtype), b[i],
                                          err_msg=name)
    assert gt.valid.sum() > 0


class _Trace:
    def __init__(self, kernels, units, busy_s):
        self.kernels, self.units, self.busy_s = kernels, units, busy_s

    def kernel_times(self, pattern):
        import re
        return [d for n, d in self.kernels if re.search(pattern, n)]


def test_training_readers_on_fixed_inputs():
    from h100_bench.work.roi_align_bytes import k2_bytes
    cfg = synthetic_fullres_config()
    peaks = {"flops_per_s": {"bfloat16": 989e12}, "hbm_bytes_per_s": 3.35e12}
    k2 = "void (anonymous namespace)::stereo_roi_align_bwd_kernel<4>(Grads)"
    tr = _Trace([(k2, 0.0015), ("void gemm_kernel(float*)", 0.002),
                 (k2, 0.0025)], units=2, busy_s=0.5)
    ctx = {"trace": tr, "cfg": cfg, "peaks": peaks, "pairs_per_step": 8,
           "flops_per_pair": 2.2e12, "pairs_per_s": 20.0, "call_s": 0.4,
           "by_span": {"train/optimizer": {"kernels": 2712.0}}}
    # 977 MB a launch (every roi valid), two launches in 4 ms: 14.6 %.
    want = 100.0 * 2 * k2_bytes(8, 128, 256, (384, 1280)) / 3.35e12 / 0.004
    assert harness.read_layer_metric("k2_roofline.train", ctx) == \
        pytest.approx(want)
    assert round(want, 2) == 14.58
    # 2.2 TFLOP a pair at 20 pairs/s of 989 TFLOP/s: 4.45 %.
    assert harness.read_layer_metric("mfu.train", ctx) == pytest.approx(
        100.0 * 2.2e12 * 20.0 / 989e12)
    assert harness.read_layer_metric("launches_per_step.train", ctx) == 1.5
    assert harness.read_layer_metric(
        "optimizer_launches_per_step.train", ctx) == 2712.0
    # 0.25 s busy a step of 0.4 s: 37.5 % idle.
    assert harness.read_layer_metric("idle_share.train", ctx) == \
        pytest.approx(37.5)
    for name in ("k2_roofline.train", "mfu.train", "launches_per_step.train",
                 "optimizer_launches_per_step.train", "idle_share.train"):
        assert harness.read_layer_metric(name, {}) is None
    no_k2 = dict(ctx, trace=_Trace([("gemm", 1.0)], 1, 1.0))
    assert harness.read_layer_metric("k2_roofline.train", no_k2) is None


def test_the_cells_files_load():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = harness.load_cell(bench, "res101_gn.train_b8")
    assert cell.chips == 1 and cell.traffic["driver"] == "train_loop"
    assert cell.config["reduced"] == []
    assert cell.config["config"] == _lists(dataclasses.asdict(
        synthetic_fullres_config()))
    assert set(cell.limits["limits"]) == {
        "target_mismatch", "loss_rel", "grad_rel_median", "grad_rel_p90",
        "update_rel", "grad_rel_max", "nonfinite_steps"}
    assert cell.limits["limits"]["target_mismatch"] == 0
    assert cell.limits["limits"]["nonfinite_steps"] == 0
    e2e = [m["name"] for m in harness.metrics_of(bench, cell.name, False)]
    assert sorted(e2e) == ["pairs_per_s", "setup_s"]
    layer = [m["name"] for m in harness.metrics_of(bench, cell.name, True)]
    assert sorted(layer) == sorted([
        "mfu.train", "k2_roofline.train", "launches_per_step.train",
        "optimizer_launches_per_step.train", "idle_share.train"])
    tr = cell.traffic
    assert tr["pool_pairs"] % tr["batch"] == 0
    assert tr["batch"] == synthetic_fullres_config().train.batch_per_device
