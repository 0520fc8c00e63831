"""Kernels rank 0's card ran per data-parallel training step (device_trace)."""
from h100_bench.readers import launches_per_unit as read  # noqa: F401
