"""Share of a training step with the card idle (%)."""
from h100_bench.readers import idle_percent as read  # noqa: F401
