"""What the harness loads: no JAX and no JAX package in a run (top-level
module names compared whole: the port's name begins with the JAX
package's), and nothing of the program in the reference."""

import os
import subprocess
import sys

from h100_bench import harness

HARNESS_MODULES = [
    "h100_bench.harness", "h100_bench.trace", "h100_bench.readers",
    "h100_bench.inputs", "h100_bench.compare.pipeline",
    "h100_bench.drivers.pipeline_loop", "h100_bench.work.flops",
    "h100_bench.work.roi_align_bytes"]
# What the drivers import of the program.
PROGRAM_MODULES = [
    "stereo_rcnn_tpu_torch.config", "stereo_rcnn_tpu_torch.inference",
    "stereo_rcnn_tpu_torch.models.detector",
    "stereo_rcnn_tpu_torch.ops.stereo_roi_align"]


def _reference_modules():
    ref = os.path.join(harness.BENCH_DIR, "reference")
    out = []
    for dirpath, _, files in os.walk(ref):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f),
                                      harness.ROOT)[:-3]
                out.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    return out


def _loaded_top_levels(modules):
    """Top-level names of every module loaded by importing ``modules``
    (and every metric reader) in a fresh interpreter."""
    code = (
        "import sys, importlib, os\n"
        f"sys.path.insert(0, {harness.ROOT!r})\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "from h100_bench import harness\n"
        "for f in sorted(os.listdir(os.path.join(harness.BENCH_DIR, "
        "'metrics'))):\n"
        "    harness.read_layer_metric(f[:-3], {})\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=env, cwd=harness.ROOT)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    loaded = _loaded_top_levels(HARNESS_MODULES + PROGRAM_MODULES)
    assert "stereo_rcnn_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_top_levels(_reference_modules() + [
        "h100_bench.compare.pipeline", "h100_bench.inputs", "h100_bench.work.flops"])
    assert not loaded & (set(harness.FORBIDDEN) | {"stereo_rcnn_tpu_torch"})


def test_whole_names_are_compared(monkeypatch):
    """``stereo_rcnn_tpu_torch`` is not the JAX package, though its name
    begins with it."""
    monkeypatch.setitem(sys.modules, "stereo_rcnn_tpu_torch_fake", sys)
    assert "stereo_rcnn_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "stereo_rcnn_tpu.fake", sys)
    assert "stereo_rcnn_tpu.fake" in harness.forbidden_modules()


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the run exits with another code than 0 and
    prints no result line."""
    import torch
    if torch.cuda.is_available():
        return      # decided here: on a card the run would measure
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "res101_kron.offline_b16", "--seed", "5", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
