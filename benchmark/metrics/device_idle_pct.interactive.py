"""100 x (traced window - the union of kernel, copy and fill intervals)
/ traced window (`benchmark.trace.idle_pct`)."""

from benchmark.trace import idle_pct as read  # noqa: F401
