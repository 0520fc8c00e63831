"""K1, the fused stereo RoIAlign forward: its bound over its time (%)."""
from h100_bench.readers import k1_roofline as read  # noqa: F401
