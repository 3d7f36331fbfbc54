"""The yardstick's peaks and least-time bounds (NVIDIA H100 SXM data
sheet, dense rates; the card's power limit is printed beside each run).

`poll_bound_ms` and `int8_conv_bound_ms` are frozen copies of the
arithmetic the program's smoke script keeps (chip_smoke.py:
`poll_bound_ms`, `int8_conv_bound`), counted from each call's own inputs:
the least time is the largest of its operations at the matching peak and
its bytes (each input read once, each output written once) at the memory
rate.
"""

from __future__ import annotations

__all__ = ["PEAKS", "PEAK_BYTES", "POLL_OPS", "POLL_MUFU", "poll_bound_ms",
           "int8_conv_bound_ms"]

# operations a second, by the precision a configuration states
PEAKS = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# the MUFU pipe: 16 results a clock an SM (CUDA C++ Programming Guide,
# compute capability 9.0), 132 SMs at the 1,980 MHz of the stated peaks
PEAK_MUFU = 16 * 132 * 1.98e9

# Operations of the polling kernel's formulation, one for each add,
# multiply, compare, division and square root. Per (detection, plane)
# pair: 3 intersections (15 + 3 divisions + 9), the top point (5 + 7 + 6),
# the winding (7 + 1 compare), |X_m - X_t| (1), 5 distances (50), the
# votes (6 compares + 5 adds), the residual sum (5) and the arg-min (3):
# 123, 9 of them on the MUFU pipe. Per plane: the sign flip and the unit
# normal, 16 (1 MUFU). Per detection: rays (68), expected distances (44),
# |d_t|^2 and d_t . d_m (10), the winner's plane (16), keypoints (45) and
# the residual (1): 184 (8 MUFU).
POLL_OPS = {"pair": 123, "plane": 16, "detection": 184}
POLL_MUFU = {"pair": 9, "plane": 1, "detection": 8}


def poll_bound_ms(valid_per_frame, rows: int, planes: int) -> float:
    """Least ms of one polling call over frames whose valid detections
    number `valid_per_frame`, each frame's `rows` detection rows (valid or
    padded) read and its keypoints, keyplane and residual (17 floats a row)
    written, against `planes` road planes."""
    b = len(valid_per_frame)
    valid = sum(valid_per_frame)
    count = {"pair": valid * planes, "plane": b * planes, "detection": valid}
    ops = sum(POLL_OPS[k] * n for k, n in count.items())
    mufu = sum(POLL_MUFU[k] * n for k, n in count.items())
    # boxes (12), dims (3) float32 and orientations int32 a row; P_inv (12)
    # and the planes (4 a plane) float32 a frame; 17 floats out a row
    nbytes = 4 * (b * rows * (12 + 3 + 1) + b * 12 + b * planes * 4
                  + b * rows * 17)
    return max(ops / PEAKS["float32"], mufu / PEAK_MUFU,
               nbytes / PEAK_BYTES) * 1e3


def int8_conv_bound_ms(x_shape, w_shape, out_shape, out_bytes: int) -> float:
    """Least ms of one int8 conv: 2 M N K operations at the int8 peak, or
    its bytes (the int8 input, the int8 weights, a float32 scale and the
    bias a channel, the output) at the memory rate, whichever is larger."""
    b, cin, h, w = x_shape
    cout, _, kh, kw = w_shape
    m = b * out_shape[2] * out_shape[3]
    ops = 2 * m * cout * cin * kh * kw
    nbytes = (b * cin * h * w + cout * cin * kh * kw
              + cout * (4 + out_bytes) + m * cout * out_bytes)
    return max(ops / PEAKS["int8"], nbytes / PEAK_BYTES) * 1e3
