"""Share of the traced window with the card idle, one camera (%)."""
from h100_bench.readers import idle_percent as read  # noqa: F401
