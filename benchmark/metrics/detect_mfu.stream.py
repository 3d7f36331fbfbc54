"""detect_mfu.stream: the reference forward's FLOPs (FlopCounterMode) a
frame times the frames finished, over the window, against the peak of the
configuration's precision (989 TFLOP/s bf16, 1,979 TOP/s int8)."""

from benchmark.lib.readers import mfu_pct as read  # noqa: F401
