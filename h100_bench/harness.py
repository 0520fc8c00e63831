"""The generic part of a run: arguments, the cell's files, the checks
around the driver, the per-layer readers and the result line."""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import resource
import sys
import time
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: Top-level module names that may not be loaded in the measured process.
FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_rcnn_tpu")
#: Kernel and build caches, at fixed paths inside the checkout.
CACHE_DIR = os.path.join(ROOT, ".bench_cache")


def process_start() -> float:
    """The ``time.time()`` at which this process started (Linux)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def host_sample() -> dict:
    """What the host was doing, read before and after a window
    (:func:`host_delta`): this process's CPU seconds and context
    switches, the machine's CPU time by state (``/proc/stat``), and the
    core this process last ran on."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"t": time.perf_counter(), "cpu": ru.ru_utime + ru.ru_stime,
           "nvcsw": ru.ru_nvcsw, "nivcsw": ru.ru_nivcsw}
    try:
        with open("/proc/stat") as f:
            out["stat"] = [int(x) for x in f.readline().split()[1:9]]
        with open("/proc/self/stat") as f:
            out["core"] = int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, ValueError, IndexError):
        pass
    return out


def host_delta(a: dict, b: dict, calls: int) -> dict:
    """The host over a window from :func:`host_sample` readings: this
    process's CPU ms per call and its CPU share of the window, its
    voluntary and involuntary context switches, the machine's busy and
    stolen shares, its mean clock (MHz) and load at the end."""
    wall = b["t"] - a["t"]
    out = {"cpu_ms_per_call": 1e3 * (b["cpu"] - a["cpu"]) / max(calls, 1),
           "cpu_share": (b["cpu"] - a["cpu"]) / wall,
           "voluntary_switches": b["nvcsw"] - a["nvcsw"],
           "involuntary_switches": b["nivcsw"] - a["nivcsw"],
           "load1": os.getloadavg()[0], "core": b.get("core")}
    if "stat" in a and "stat" in b:
        d = [y - x for x, y in zip(a["stat"], b["stat"])]
        total = max(sum(d), 1)
        out["machine_busy_share"] = 1.0 - (d[3] + d[4]) / total
        out["steal_share"] = d[7] / total
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
        out["mhz"] = [min(mhz), sum(mhz) / len(mhz), max(mhz)]
    except (OSError, ValueError, ZeroDivisionError):
        pass
    return out


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration and traffic."""

    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]      # configs/<config>.json
    traffic_name: str
    traffic: Dict[str, Any]     # traffic/<traffic>.json
    limits: Dict[str, Any]      # limits/<cell>.json


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end values by metric name,
    the context the per-layer readers read, and the correctness check."""

    e2e: Dict[str, float]
    layer: Dict[str, Any]
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]   # name -> {"value", "limit"}
    memory_peak_bytes: int
    device_count: int
    trace: Any = None           # trace.Trace of the traced window


def _load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` with its files, found by name under
    ``root`` (a checkout)."""
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=_load_json(root, conf["file"]),
                traffic_name=w["traffic"],
                traffic=_load_json(bench_dir, "traffic",
                                   w["traffic"] + ".json"),
                limits=_load_json(bench_dir, "limits", name + ".json"))


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` 0) or per-layer metrics
    (``trace`` 1): those whose ``workloads`` name it, or that have none."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if cell in m.get("workloads", [cell])]


def read_layer_metric(name: str, ctx: dict,
                      bench_dir: str = BENCH_DIR) -> Optional[float]:
    """``metrics/<name>.py``'s ``read(ctx)``: a number, or None where
    there was nothing to read."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def check_cards(chips: int) -> Optional[str]:
    import torch
    if not torch.cuda.is_available():
        return "no CUDA card: this benchmark measures NVIDIA H100 cards"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} CUDA cards, "
                f"{torch.cuda.device_count()} visible")
    return None


def result_line(cell: Cell, bench: dict, trace: bool,
                out: Outcome) -> dict:
    import torch
    metrics = {}
    for m in metrics_of(bench, cell.name, trace):
        if trace:
            value = read_layer_metric(m["name"], out.layer)
        else:
            value = out.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(c["value"] <= c["limit"] for c in out.checks.values())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": out.device_count,
              "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = out.checks
    return line


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_cache_dirs() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)


def main(argv=None) -> int:
    t_start = process_start()
    args = parse(argv)
    bench = _load_json(ROOT, "BENCHMARK.json")
    cell = load_cell(bench, args.workload)
    set_cache_dirs()
    problem = check_cards(cell.chips)
    if problem:
        print(problem, file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    driver = importlib.import_module(
        "h100_bench.drivers." + cell.traffic["driver"])
    out = driver.run(cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print("modules of JAX or of the JAX package were loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    line = result_line(cell, bench, bool(args.trace), out)
    print("stats " + json.dumps(out.layer.get("stats", {})), file=sys.stderr)
    for name, c in out.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
