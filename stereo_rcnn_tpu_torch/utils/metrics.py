"""Structured training and inference metrics (plain Python).

A copy of ``stereo_rcnn_tpu.utils.metrics``: a step-time and pairs-per-
second meter, and a CSV writer with a periodic stdout line.  The
optional TensorBoard writer (``torch.utils.tensorboard``) degrades to
CSV only, with a warning, where it is not installed.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Mapping, Optional


class StepTimer:
    """Tracks step wall-times; reports p50 latency and throughput."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.time()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    @property
    def p50(self) -> float:
        if not self.times:
            return float("nan")
        s = sorted(self.times)
        return s[len(s) // 2]

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.p50 if self.times else float("nan")


class MetricsLogger:
    """CSV metrics sink + periodic stdout line (the six losses; the
    learned uncertainties go to the CSV only).

    ``tb_dir`` additionally writes TensorBoard event files; without a
    writer it warns and keeps the CSV.
    """

    def __init__(self, csv_path: Optional[str] = None,
                 print_every: int = 20, tb_dir: Optional[str] = None):
        self.csv_path = csv_path
        self.print_every = print_every
        self._writer = None
        self._file = None
        self._keys = None
        self._tb = None
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(tb_dir)
            except Exception as e:  # noqa: BLE001 — observability is optional
                print(f"# tensorboard writer unavailable ({e}); CSV only")

    def log(self, step: int, metrics: Mapping[str, float]) -> None:
        metrics = {k: float(v) for k, v in metrics.items()}
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)
        if self.csv_path:
            if self._writer is None:
                os.makedirs(os.path.dirname(self.csv_path) or ".",
                            exist_ok=True)
                self._file = open(self.csv_path, "a", newline="")
                self._keys = ["step"] + sorted(metrics)
                self._writer = csv.DictWriter(self._file,
                                              fieldnames=self._keys,
                                              extrasaction="ignore")
                if self._file.tell() == 0:
                    self._writer.writeheader()
            self._writer.writerow({"step": step, **metrics})
            self._file.flush()
        if self.print_every and step % self.print_every == 0:
            parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(
                metrics.items()) if not k.startswith("uncert_"))
            print(f"[step {step}] {parts}", flush=True)

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._tb is not None:
            self._tb.close()
