"""Kernels the card ran per pipeline call at batch 16 (device_trace)."""
from h100_bench.readers import launches_per_unit as read  # noqa: F401
