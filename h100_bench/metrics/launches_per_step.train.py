"""Kernels the card ran per training step at batch 8 (device_trace)."""
from h100_bench.readers import launches_per_unit as read  # noqa: F401
