"""Device: the share of the traced span in which no kernel, copy or set ran."""
from port_bench.readers import idle_pct as read  # noqa: F401
