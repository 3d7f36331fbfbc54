"""conv_kernel_roofline.offline: the int8 conv sites' least time (frozen
int8_conv_bound over every site's shapes) over conv_kernel's device time
in the trace."""

from benchmark.lib.readers import conv_roofline_pct as read  # noqa: F401
