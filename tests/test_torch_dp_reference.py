"""The data-parallel training step against the benchmark's float32
reference step at the global batch, on the CPU, and the readers of the
four-card training cell (``res101_gn.train_b8x4``).

Two spawned gloo ranks (``tests/torch_dp_worker.py::dp_steps_main``, the
port only) take two ``data_parallel_train_step`` steps of a global batch
of four pairs at the narrowed tiny configuration of
``tests/test_torch_train_bench.py``, each step with the global batch's
uniforms.  Here the reference (``h100_bench/reference/train/step.py``:
one process, blocks of one image, no all-reduce) repeats each step from
the state the ranks started it from, on the global batch and on the
ranks' proposals.

Tolerances are ``tests/test_torch_train_bench.py``'s: both sides do the
same float32 arithmetic in other orders (here the mean of two per-rank
means against a sum over four blocks), so they agree to a few float32
roundings (a bf16 rounding is 4e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch

from h100_bench import harness
from h100_bench.compare.train import compare_step, Record
from h100_bench.drivers.train_loop import render_train_pool, uniforms_of
from h100_bench.reference.config import load_config as ref_load_config
from h100_bench.reference.train.step import Batch, reference_step
from h100_bench.reference.train.targets import GroundTruth
from h100_bench.reference.train.weights import training_state_dict
from h100_bench.work.collective_bytes import (NVLINK_BYTES_PER_S,
                                              all_reduce_bound_s, bus_bytes)
from stereo_rcnn_tpu_torch.parallel.launch import spawn
from tests import torch_dp_worker
from tests.test_torch_train_bench import (GRAD_REL, LOSS_REL, PARAM_REL,
                                          UPDATE_REL, _lists, _tiny)
from tests.torch_threads import one_torch_thread  # noqa: F401

RANKS, B = 2, 2           # ranks, pairs per rank
GLOBAL = RANKS * B
SEED = 2**31 + 4111
SPE = 4
#: Leaves every rank hands back whole after each step.
WATCHED = ("uncert", "rcnn_head.RCNN_fc6.weight",
           "backbone_net.RCNN_layer4.0.conv2.weight")


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_ref")
    cfg = dataclasses.replace(_tiny(), train=dataclasses.replace(
        _tiny().train, batch_per_device=B))
    rcfg = ref_load_config(None, overrides=_lists(dataclasses.asdict(cfg)))
    left, right, gt = render_train_pool(rcfg, GLOBAL, 3, SEED, threads=1)
    sd = training_state_dict(rcfg, SEED, "cpu")
    uniforms = [uniforms_of(rcfg, 13, k, GLOBAL, "cpu") for k in range(2)]
    inputs = str(tmp / "inputs.pt")
    torch.save({"cfg": cfg, "sd": sd, "batch": (left, right, gt),
                "uniforms": uniforms, "steps_per_epoch": SPE,
                "watched": WATCHED}, inputs)
    codes = spawn(torch_dp_worker.dp_steps_main, RANKS, inputs, str(tmp),
                  timeout=300)
    assert codes == [0] * RANKS, codes
    ranks = [torch.load(str(tmp / f"dp{r}.pt"), weights_only=False)
             for r in range(RANKS)]
    gt_t = GroundTruth(*[torch.from_numpy(np.ascontiguousarray(x))
                         for x in gt])
    batch = Batch(torch.from_numpy(left), torch.from_numpy(right), gt_t)
    refs = []
    for k, step in enumerate(ranks[0]["steps"]):
        ev = [r["steps"][k]["evidence"] for r in ranks]
        props = {n: torch.cat([e[n] for e in ev])
                 for n in ("left", "right", "valid")}
        refs.append(reference_step(rcfg, step["before"], step["trace"],
                                   step["count"], batch, uniforms[k], SPE,
                                   proposals=props))
    return dict(ranks=ranks, refs=refs, rcfg=rcfg, batch=batch,
                uniforms=uniforms)


def _rel(a, b):
    return float((a.double() - b.double()).norm() /
                 b.double().norm().clamp(min=1e-30))


def _update(after, before, names):
    return torch.cat([(after[n].double() - before[n].double()).reshape(-1)
                      for n in sorted(names)])


@pytest.mark.parametrize("k", [0, 1])
def test_averaged_step_matches_the_reference_at_the_global_batch(dp, k):
    step, ref = dp["ranks"][0]["steps"][k], dp["refs"][k]
    for n in ref.losses:
        assert _rel(step["metrics"][n], ref.losses[n]) <= LOSS_REL, n
    fg = torch.cat([r["steps"][k]["evidence"]["num_fg_rcnn"]
                    for r in dp["ranks"]])
    assert torch.equal(fg, ref.num_fg_rcnn)
    assert set(step["grads"]) >= set(ref.grads)
    gaps = {n: _rel(step["grads"][n], ref.grads[n]) for n in ref.grads}
    assert max(gaps.values()) <= GRAD_REL, max(gaps, key=gaps.get)
    assert _rel(step["metrics"]["grad_norm"], ref.g_norm) <= GRAD_REL
    for n in ref.params:
        assert _rel(step["after"][n], ref.params[n]) <= PARAM_REL, n
    assert _rel(_update(step["after"], step["before"], ref.grads),
                _update(ref.params, step["before"], ref.grads)
                ) <= UPDATE_REL


def test_the_check_reads_the_data_parallel_step_as_sound(dp):
    """``compare.train``'s numbers on the record the cell's driver builds
    from the ranks (their proposals and counts gathered in rank order)."""
    step, ref = dp["ranks"][0]["steps"][0], dp["refs"][0]
    ev = [r["steps"][0]["evidence"] for r in dp["ranks"]]
    rec = Record(
        count=step["count"], params=step["before"], trace=step["trace"],
        batch=dp["batch"], uniforms=dp["uniforms"][0],
        proposals={n: torch.cat([e[n] for e in ev])
                   for n in ("left", "right", "valid")},
        losses={n: step["metrics"][n] for n in ref.losses},
        num_fg_rpn=torch.cat([e["num_fg_rpn"] for e in ev]),
        num_fg_rcnn=torch.cat([e["num_fg_rcnn"] for e in ev]),
        grads=step["grads"], g_norm=step["metrics"]["grad_norm"],
        after=step["after"])
    got = compare_step(dp["rcfg"], rec, ref)
    assert got["target_mismatch"] == 0
    assert got["loss_rel"] <= LOSS_REL
    assert got["grad_rel_max"] <= GRAD_REL
    assert got["update_rel"] <= UPDATE_REL


@pytest.mark.parametrize("k", [0, 1])
def test_ranks_sample_as_one_process_at_the_global_batch(dp, k):
    """The anchors and RoIs the ranks sampled, in rank order, are the
    reference's target sampling of the global batch with the global
    uniforms (``sample_mismatch`` 0); with other draws they are not."""
    from h100_bench.drivers.train_dp_loop import SAMPLED, sample_mismatch
    ev = [r["steps"][k]["evidence"] for r in dp["ranks"]]
    chosen = {n: torch.cat([e[n] for e in ev]) for n in SAMPLED}
    rec = Record(
        count=None, params=None, trace=None, batch=dp["batch"],
        uniforms=dp["uniforms"][k],
        proposals={n: torch.cat([e[n] for e in ev])
                   for n in ("left", "right", "valid")},
        losses=None, num_fg_rpn=None, num_fg_rcnn=None, grads=None,
        g_norm=None, after=None)
    assert sample_mismatch(dp["rcfg"], rec, chosen) == 0.0
    other = rec._replace(uniforms=dp["uniforms"][1 - k])
    assert sample_mismatch(dp["rcfg"], other, chosen) == GLOBAL


def test_ranks_hold_the_same_bits_after_two_steps(dp):
    digests = {r["digest"] for r in dp["ranks"]}
    assert len(digests) == 1
    a, b = (r["steps"][1]["after"] for r in dp["ranks"])
    assert set(b) == set(WATCHED)
    for n in WATCHED:
        assert torch.equal(a[n], b[n]), n


def test_counts_see_the_gradient_all_reduce(dp):
    """One all-reduce of the float32 gradient buffer a step (``numel x
    4`` bytes) and one of the step's metrics, on every rank."""
    for r in dp["ranks"]:
        for step in r["steps"]:
            c = step["counts"]
            assert c["all_reduce"] == (1, 4 * step["live"])
            assert c["all_reduce_metrics"].calls == 1
            assert c["all_reduce_metrics"].bytes % 4 == 0
            assert set(c) == {"all_reduce", "all_reduce_metrics"}


def test_collective_bytes():
    assert bus_bytes(4, 400) == 600.0
    assert bus_bytes(2, 400) == 400.0
    assert bus_bytes(1, 400) == 0.0
    assert all_reduce_bound_s(4, 421.9e6) == pytest.approx(
        632.85e6 / NVLINK_BYTES_PER_S)


class _Trace:
    def __init__(self, kernels, units, busy_s):
        self.kernels, self.units, self.busy_s = kernels, units, busy_s


def test_readers_of_the_four_card_cell():
    from stereo_rcnn_tpu_torch.config import synthetic_fullres_config
    peaks = {"flops_per_s": {"bfloat16": 989e12}}
    tr = _Trace([("k", 1e-3)] * 30, units=2, busy_s=0.7)
    ctx = {"trace": tr, "cfg": synthetic_fullres_config(), "peaks": peaks,
           "cards": 4, "flops_per_pair": 2.2e12, "pairs_per_s": 80.0,
           "call_s": 0.4, "collective_s": [0.004, 0.002],
           "traced_step_s": 0.5,
           # Rank 0 waited at both steps; ranks 2 and 1 came last.
           "collective_s_by_rank": [[0.004, 0.002], [0.003, 0.0015],
                                    [0.0016, 0.0018], [0.0035, 0.0019]],
           "gradient_bytes": 421.9e6}

    def read(name):
        return harness.read_layer_metric(name, ctx)

    assert read("mfu.train_x4") == pytest.approx(
        100 * 2.2e12 * 80.0 / (4 * 989e12))
    assert read("all_reduce_share.train_x4") == pytest.approx(
        100 * 0.003 / 0.5)
    # Shortest per step: 1.6 ms, 1.5 ms; their median 1.55 ms.
    assert read("all_reduce_roofline.train_x4") == pytest.approx(
        100 * 632.85e6 / 450e9 / 0.00155)
    assert read("launches_per_step.train_x4") == 15.0
    assert read("idle_share.train_x4") == pytest.approx(
        100 * (1 - 0.35 / 0.4))
    # A program without the counters: no bytes, no roofline.
    assert harness.read_layer_metric(
        "all_reduce_roofline.train_x4", {**ctx, "gradient_bytes": None}
    ) is None
    for name in ("mfu.train_x4", "all_reduce_share.train_x4",
                 "all_reduce_roofline.train_x4",
                 "launches_per_step.train_x4", "idle_share.train_x4"):
        assert harness.read_layer_metric(name, {}) is None


def test_collective_span_times_from_a_profiled_window():
    """The driver's per-step all-reduce time: the kernels whose launch
    lies inside each ``train/all_reduce/collective`` span."""
    from h100_bench.drivers.train_dp_loop import COLLECTIVE, _span_kernel_s
    from h100_bench.stages import Window
    win = Window(w0=0.0, w1=100.0, units=2,
                 ranges=[(10.0, 20.0, COLLECTIVE), (12.0, 13.0, "x"),
                         (60.0, 70.0, COLLECTIVE), (0.0, 90.0, "train/a")],
                 launches={1: 11.0, 2: 61.0, 3: 5.0, 4: 62.0},
                 kernels=[(30.0, 31.5, 1), (80.0, 82.0, 2), (5.0, 9.0, 3),
                          (82.0, 82.5, 4), (85.0, 86.0, 99)],
                 busy=[], syncs=[])
    assert _span_kernel_s(win, COLLECTIVE) == pytest.approx(
        [1.5e-6, 2.5e-6])
