"""device_idle_pct.stream: share of the traced window with no operation
running on the card (torch.profiler)."""

from benchmark.lib.readers import idle_pct as read  # noqa: F401
