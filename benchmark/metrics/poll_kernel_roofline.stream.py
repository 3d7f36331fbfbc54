"""poll_kernel_roofline.stream: the polling calls' least time (frozen
poll_bound_ms on each call's valid detections and planes) over poll_kernel's
device time in the trace."""

from benchmark.lib.readers import poll_roofline_pct as read  # noqa: F401
