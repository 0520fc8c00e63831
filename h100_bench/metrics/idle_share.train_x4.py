"""Share of a data-parallel training step with rank 0's card idle (%)."""
from h100_bench.readers import idle_percent as read  # noqa: F401
