"""int8 convolution on the card: wrappers of the hand-written CUDA kernels
in ../csrc/int8_conv.cu, the activation quantize pass and the int8 conv
with its dequantize and bias epilogue.

Together they replace the conv rewrite of
ground_plane_polling_tpu/models/quantize.py::quantize_apply (quantize x,
int8 x int8 -> int32 conv, dequantize), which XLA lowers on the TPU. CUDA
tensors go through the kernels, which raise if they cannot build or
launch; the wrappers check their inputs, allocate the outputs with
torch.empty and launch on the current stream. CPU tensors go through the
plain versions in ops.int8_conv, and only they do.

Layouts on the card: `quantize` returns an NCHW int8 tensor in
channels-last memory (NHWC), which `conv2d` takes with a weight in
channels-last memory (OIHW indexed, [Cout][kh][kw][Cin] in memory); the
output is NCHW in channels-last memory, in float32 or bf16, as the float
conv's output on the card. `padding` is ((top, bottom), (left, right)),
so Flax's asymmetric SAME padding needs no pass of its own.

The conv is one launch per call, of a tile (BM, BN) of TILES over a number
of splits of K that `plan_conv` picks from the conv's M, N and K and the
blocks the card holds at once (the occupancy API), once per device and
shape. With more than one
split, the splits' int32 partial tiles meet in a workspace of the
wrapper's, and per output tile a counter that the kernel leaves at 0.
Workspaces are kept per device and stream, so launches on one stream never
share them with launches that could run at the same time.

The library is compiled with nvcc at first use (kernels/nvcc_build.py),
with IEEE division and no FMA contraction: the quantize pass divides as
the JAX package does. `QUANTIZE_LAUNCHES` and `CONV_LAUNCHES` count the
launches of each kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..ops import int8_conv as twin
from .nvcc_build import CSRC, build_library

__all__ = ["CONV_LAUNCHES", "K_STEP", "MIN_SPLIT_STEPS", "QUANTIZE_LAUNCHES",
           "SOURCE", "TILES", "WIDTHS", "build", "card_slots", "conv2d",
           "conv2d_accumulate", "conv_plan", "plan_conv", "plan_cost",
           "quantize", "split_counts", "split_ranges", "workspace_size"]

QUANTIZE_LAUNCHES = 0
CONV_LAUNCHES = 0

SOURCE = CSRC / "int8_conv.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-prec-div=true", "-fmad=false", "-Xptxas=-v",
              "-shared", "-Xcompiler", "-fPIC")
# csrc/int8_conv.cu: K bytes a pipeline stage takes (kBK), the compiled
# tile widths (wgmma_s8.cuh) and tiles
K_STEP = 128
WIDTHS = (48, 64, 96, 128, 144)
TILES = tuple((bm, bn) for bm in (64, 128) for bn in WIDTHS)
# fewest K steps a split of K keeps: enough for the ring to fill and run
MIN_SPLIT_STEPS = 4
# plan_cost's model of the H100, fitted to the conv kernel's times at the
# detector's shapes under every plan (NVIDIA H100 80GB HBM3, 700 W): the
# rate at which the L2 cache feeds the SMs, the time a block takes a K
# step where latency bounds it, and the steps its ring fill and epilogue
# cost
L2_BYTES_PER_US = 6.0e6
STEP_US = 1.35
FILL_STEPS = 3
_FLOATS = (torch.float32, torch.bfloat16)
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_LIMIT = 2**31

_lib = None
_slots = {}       # device index -> ({(bm, bn): blocks held}, SMs)
_plans = {}       # (device index, M, N, K) -> plan_conv's plan
_workspaces = {}  # (device index, stream) -> (partials, counters)


def build() -> Path:
    """Compile the kernels (once per source, header and flag set) and
    return the path of the shared library; nvcc's report lands beside it
    as `.log`."""
    return build_library(SOURCE, NVCC_FLAGS, "libgpp_int8_conv")


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gpp_int8_quantize.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
               ctypes.c_void_p])
        lib.gpp_int8_quantize.restype = ctypes.c_int
        lib.gpp_int8_conv_config.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3)
        lib.gpp_int8_conv_config.restype = ctypes.c_int
        lib.gpp_int8_conv.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 12
            + [ctypes.c_float] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
        lib.gpp_int8_conv.restype = ctypes.c_int
        _lib = lib
    return _lib


def split_ranges(steps: int, splits: int) -> list:
    """The kernel's ranges of K steps, [begin, end), for `splits` splits of
    `steps`: ceil(steps / splits) a split, the last shorter, none empty
    (so there may be fewer ranges than `splits`)."""
    per = -(-steps // max(1, splits))
    return [(b, min(steps, b + per)) for b in range(0, steps, per)]


def split_counts(steps: int) -> list:
    """The split counts the planner may give a conv of `steps` K steps: 1,
    and each count of `split_ranges` whose ranges keep MIN_SPLIT_STEPS
    steps (the last may be shorter)."""
    return sorted({1} | {len(split_ranges(steps, s))
                         for s in range(2, steps + 1)
                         if -(-steps // s) >= MIN_SPLIT_STEPS})


def plan_cost(m: int, n: int, k: int, plan, slots) -> float:
    """The planner's model of a launch's time, in microseconds: the larger
    of (a) the bytes its blocks pull through the L2 cache (a bm + bn row of
    K_STEP bytes a K step, and each split's partial tile written and read
    back) at L2_BYTES_PER_US, and (b) ceil(blocks / slots) rounds of
    resident blocks, each FILL_STEPS and its K steps of STEP_US; a split
    launch adds half a step for the partial tile every block writes and
    one step for each further split that the last block of a tile adds
    up."""
    bm, bn, splits = plan
    steps = -(-k // K_STEP)
    blocks = -(-m // bm) * -(-n // bn) * splits
    per = -(-steps // splits)
    l2 = blocks * per * (bm + bn) * K_STEP
    if splits > 1:
        l2 += 2 * blocks * bm * bn * 4
    chain = -(-blocks // slots[(bm, bn)]) * (FILL_STEPS + per)
    if splits > 1:
        chain += 0.5 + (splits - 1)
    return max(l2 / L2_BYTES_PER_US, chain * STEP_US)


def plan_conv(m: int, n: int, k: int, slots, sms: int) -> tuple:
    """(BM, BN, splits) of one conv launch: M = B Ho Wo rows, N = Cout
    channels, K = kh kw Cin bytes; `slots` maps each tile of TILES to the
    blocks of it that the card holds at once, on `sms` SMs.

    BN is the narrowest compiled width that holds N up to 144 channels,
    else 128. K is split only where a tile's grid holds fewer
    blocks than the card does at once, into a count of `split_counts`
    that gives every SM a block where K has the steps for it. Among those
    plans the one of least `plan_cost` wins; ties go to the shorter tile
    (more blocks to hide each other's latency), then to fewer splits."""
    steps = -(-k // K_STEP)
    bn = min([w for w in WIDTHS if w >= n] or [128])
    counts = split_counts(steps)
    plans = []
    for bm in (64, 128):
        tiles = -(-m // bm) * -(-n // bn)
        if tiles >= slots[(bm, bn)]:
            plans.append((bm, bn, 1))
            continue
        # the fewest splits that give every SM a block, and more
        fill = [c for c in counts if tiles * c >= sms] or counts[-1:]
        plans += [(bm, bn, c) for c in counts if c >= fill[0]]
    return min(plans, key=lambda p: plan_cost(m, n, k, p, slots))


def workspace_size(m: int, n: int, plan) -> tuple:
    """(int32 partials, counters) a launch of `plan` needs: none for one
    split, else a bm x bn partial tile per split and output tile and a
    counter per output tile."""
    bm, bn, splits = plan
    if splits == 1:
        return 0, 0
    tiles = -(-m // bm) * -(-n // bn)
    return tiles * splits * bm * bn, tiles


def card_slots(device) -> tuple:
    """({(bm, bn): blocks of that tile the card holds at once}, SMs) on
    `device`, from the occupancy API (SMs times resident blocks per SM)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.index not in _slots:
        lib = _library()
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        slots = {}
        with torch.cuda.device(device):
            for bm, bn in TILES:
                threads, smem, per_sm = (ctypes.c_int(), ctypes.c_int(),
                                         ctypes.c_int())
                err = lib.gpp_int8_conv_config(
                    bm, bn, ctypes.byref(threads), ctypes.byref(smem),
                    ctypes.byref(per_sm))
                if err != 0 or per_sm.value < 1:
                    raise RuntimeError(
                        f"int8 conv tile {bm}x{bn} does not fit the card: "
                        f"CUDA error {err}, {per_sm.value} blocks per SM at "
                        f"{smem.value} bytes of shared memory")
                slots[(bm, bn)] = sms * per_sm.value
        _slots[device.index] = slots, sms
    return _slots[device.index]


def _workspace(device, stream, n_partials, n_counters):
    """int32 partials and zeroed counters for one launch, kept per device
    and stream; the kernel leaves the counters at 0."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < n_partials or ws[1].numel() < \
            n_counters:
        if ws is not None:  # grow, never shrink: sites alternate
            n_partials = max(n_partials, ws[0].numel())
            n_counters = max(n_counters, ws[1].numel())
        ws = (torch.empty(n_partials, dtype=torch.int32, device=device),
              torch.zeros(n_counters, dtype=torch.int32, device=device))
        _workspaces[key] = ws
    return ws


def _call(device, fn, *args):
    """fn(*args) with `device` current; raises on a CUDA error."""
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: CUDA error "
                           f"{err}")


def _stream(device) -> int:
    # the raw handle of the current stream (torch.cuda.current_stream
    # builds a Stream object, several microseconds a call)
    return torch._C._cuda_getCurrentRawStream(device.index)


def _nhwc(t: torch.Tensor) -> bool:
    return t.permute(0, 2, 3, 1).is_contiguous()


def _on_cuda(tensors, device):
    for t in tensors:
        if t is not None and (not t.is_cuda or t.device != device):
            raise ValueError(f"int8 conv kernels take tensors on one CUDA "
                             f"device, got {t.device} beside {device}")


def _quantize(x: torch.Tensor, s_x: float) -> torch.Tensor:
    """The quantize kernel on a CUDA tensor."""
    global QUANTIZE_LAUNCHES
    if x.dim() != 4 or x.dtype not in _FLOATS:
        raise ValueError(f"quantize takes a 4-D float32 or bf16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.numel() >= _LIMIT or not s_x > 0:
        raise ValueError(f"quantize: {tuple(x.shape)} at scale {s_x}")
    _on_cuda([x], x.device)
    b, c, h, w = x.shape
    out = torch.empty((b, h, w, c), dtype=torch.int8, device=x.device)
    if out.numel():
        dense = _nhwc(x) and x.data_ptr() % 16 == 0
        QUANTIZE_LAUNCHES += 1
        _call(x.device, _library().gpp_int8_quantize, x.data_ptr(),
              x.dtype == torch.bfloat16, b, c, h, w, *x.stride(), dense,
              float(s_x), out.data_ptr(), _stream(x.device))
    return out.permute(0, 3, 1, 2)


def quantize(x: torch.Tensor, s_x: float) -> torch.Tensor:
    """int8 round(x / s_x) clamped to +-127 of an NCHW float32 or bf16
    tensor: the kernel on a CUDA tensor (NHWC int8 out), the plain version
    on a CPU one."""
    if x.device.type == "cpu":
        return twin.quantize_activation(x, s_x)
    return _quantize(x, s_x)


def _geometry(x8, w8, stride, padding):
    """(m, n, k, ho, wo) of the conv, checking the operands' shapes."""
    if (x8.dim() != 4 or w8.dim() != 4 or x8.dtype != torch.int8
            or w8.dtype != torch.int8 or x8.shape[1] != w8.shape[1]):
        raise ValueError(f"int8 conv takes int8 NCHW x and OIHW w, got "
                         f"{x8.dtype} {tuple(x8.shape)} and {w8.dtype} "
                         f"{tuple(w8.shape)}")
    b, c, h, w = x8.shape
    o, _, kh, kw = w8.shape
    (top, bottom), (left, right) = padding
    ho = (h + top + bottom - kh) // stride + 1 if stride >= 1 else -1
    wo = (w + left + right - kw) // stride + 1 if stride >= 1 else -1
    if (min(top, bottom, left, right) < 0 or stride < 1 or ho < 0 or wo < 0
            or c * kh * kw == 0):
        raise ValueError(f"int8 conv: stride {stride}, padding {padding} on "
                         f"{h}x{w} with a {kh}x{kw} kernel over {c} "
                         f"channels")
    return b * ho * wo, o, c * kh * kw, ho, wo


def _card_plan(device, m, n, k) -> tuple:
    """plan_conv on the card's slots, once per device and conv shape: a
    forward asks for the same 136 plans every call."""
    key = (device.index, m, n, k)
    if key not in _plans:
        _plans[key] = plan_conv(m, n, k, *card_slots(device))
    return _plans[key]


def conv_plan(x8, w8, stride: int, padding) -> tuple:
    """The (BM, BN, splits) that conv2d launches for these CUDA operands
    (plan_conv on the card's slots)."""
    m, n, k, _, _ = _geometry(x8, w8, stride, padding)
    return _card_plan(x8.device, m, n, k)


def _check_plan(plan, k):
    bm, bn, splits = plan
    if (bm, bn) not in TILES or not 1 <= splits <= -(-k // K_STEP):
        raise ValueError(f"int8 conv plan {plan}: tiles {TILES}, 1 to "
                         f"{-(-k // K_STEP)} splits")
    return bm, bn, len(split_ranges(-(-k // K_STEP), splits))


def _launch(x8, w8, s_x, s_w, bias, stride, padding, out_dtype, plan=None):
    """The conv kernel on CUDA tensors; `plan` fixes (BM, BN, splits)
    (default: plan_conv)."""
    global CONV_LAUNCHES
    m, o, k, ho, wo = _geometry(x8, w8, stride, padding)
    if not (_nhwc(x8) and _nhwc(w8)):
        raise ValueError("int8 conv takes x and w in channels-last memory")
    b, c, h, w = x8.shape
    _, _, kh, kw = w8.shape
    (top, _), (left, _) = padding
    if x8.numel() >= _LIMIT or w8.numel() >= _LIMIT or m * o >= _LIMIT:
        raise ValueError(f"int8 conv too large: x {tuple(x8.shape)}, w "
                         f"{tuple(w8.shape)}")
    if out_dtype != torch.int32:
        if (s_w.dtype != torch.float32 or tuple(s_w.shape) != (o,)
                or not s_w.is_contiguous()):
            raise ValueError(f"int8 conv: s_w must be ({o},) float32")
        if bias is not None and (bias.dtype != out_dtype or tuple(
                bias.shape) != (o,) or not bias.is_contiguous()):
            raise ValueError(f"int8 conv: bias must be ({o},) {out_dtype}")
    if plan is not None:
        plan = _check_plan(plan, k)
    device = x8.device
    _on_cuda([x8, w8, s_w, bias], device)
    if c % 16 == 0 and (x8.data_ptr() % 16 or w8.data_ptr() % 16):
        raise ValueError("int8 conv: x and w must be 16-byte aligned")
    out = torch.empty((b, ho, wo, o), dtype=out_dtype, device=device)
    if out.numel():
        bm, bn, splits = plan or _card_plan(device, m, o, k)
        n_partials, n_counters = workspace_size(m, o, (bm, bn, splits))
        if n_partials >= _LIMIT:
            raise ValueError(f"int8 conv plan {(bm, bn, splits)} needs "
                             f"{n_partials} partial sums")
        stream = _stream(device)
        partials = counters = None
        if splits > 1:
            ws = _workspace(device, stream, n_partials, n_counters)
            partials, counters = ws[0].data_ptr(), ws[1].data_ptr()
        CONV_LAUNCHES += 1
        _call(device, _library().gpp_int8_conv, x8.data_ptr(),
              w8.data_ptr(), b, h, w, c, o, kh, kw, stride, top, left, ho,
              wo, float(s_x), s_w.data_ptr() if s_w is not None else None,
              bias.data_ptr() if bias is not None else None, out.data_ptr(),
              _KINDS[out_dtype], bm, bn, splits, partials, counters, stream)
    return out.permute(0, 3, 1, 2)


def conv2d(x8, w8, s_x: float, s_w, bias, stride: int, padding,
           out_dtype: torch.dtype) -> torch.Tensor:
    """int8 conv of x8 (N, Cin, H, W) with w8 (Cout, Cin, kh, kw),
    dequantized by s_x * s_w[c] into `out_dtype` (float32 or bf16), plus
    `bias` ((Cout,) of `out_dtype`, or None): the kernel on CUDA tensors,
    ops.int8_conv.int8_conv2d on CPU ones."""
    if out_dtype not in _FLOATS:
        raise ValueError(f"int8 conv writes float32 or bf16, not {out_dtype}")
    if x8.device.type == "cpu":
        return twin.int8_conv2d(x8, w8, s_x, s_w, bias, stride, padding,
                                out_dtype)
    return _launch(x8, w8, s_x, s_w, bias, stride, padding, out_dtype)


def conv2d_accumulate(x8, w8, stride: int, padding) -> torch.Tensor:
    """The raw int32 accumulators of the same conv (the kernel's third
    output kind; ops.int8_conv.conv2d_int8 on CPU tensors)."""
    if x8.device.type == "cpu":
        return twin.conv2d_int8(x8, w8, stride, padding)
    return _launch(x8, w8, 0.0, None, None, stride, padding, torch.int32)
