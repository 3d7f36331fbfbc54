"""Plain float32 reference of the GPP RetinaNet forward: ResNet v1 trunk
with frozen batch norm, FPN, and the box, dimension and classification
heads over P3..P7, as functions of a flat dict of weights.

It follows the reference detector (keras_retinanet_3D: keras-resnet
ResNet-50 with frozen BN, the RetinaNet FPN with P6 from C5 and P7 from
relu(P6), heads shared over the levels: 4 conv+relu towers of 512 (box),
128 (dimension) and 256 (classification) channels and an out conv each)
and the layout the measured program loads its weights in: conv kernels
OIHW, each frozen BN as a per-channel scale and shift, the keys named as
the program's module tree names them. Padding is XLA's SAME where the
detector's Flax form uses it: the stem max-pool and the stride-2 P6 and
P7 convs put an odd pixel after (bottom, right); the stem conv pads 3
pixels each side; in a bottleneck the stride sits on the 1x1 conv1 and the
1x1 projection. Upsampling is nearest-neighbour with half-pixel centres
('nearest-exact'), an exact 2x repeat on canvases padded to 32.

`forward(weights, images, conv=...)`: images NCHW float32 (BGR, BGR mean
subtracted); returns the per-anchor regression (B, A, 12), dimension
regression (B, A, 3C) and sigmoid classification (B, A, 8C), anchors in
(level, row, column, anchor) order. `conv(site, x, weight, bias, stride,
padding)` computes every conv, so that the int8 and int4 forms
(`quantized_conv`) and the shape census (`conv_census`) share this one
forward. Nothing here imports the measured program.
"""

from __future__ import annotations

import itertools
import math
from collections import OrderedDict

import torch
import torch.nn.functional as F

__all__ = ["STAGES", "BN_EPS", "param_spec", "forward", "float_conv",
           "same_padding", "calibrate", "quantized_conv", "conv_census",
           "flops_per_frame"]

STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
          "resnet152": (3, 8, 36, 3)}
BN_EPS = 1e-5
HEADS = (("regression", "box", 512, 12), ("regression_dim", "dim", 128, 3),
         ("classification", "cls", 256, 8))


def param_spec(cfg) -> "OrderedDict[str, tuple]":
    """name -> (shape, kind) of every weight, kind one of 'trunk' (a
    lecun-normal conv kernel of the trunk or FPN), 'tower' (a head conv
    kernel), 'cls_out' (the classification out kernel), 'bias', 'bn_scale',
    'bn_shift'."""
    spec = OrderedDict()
    classes, anchors = cfg["num_classes"], cfg["num_anchors"]
    f = cfg["feature_size"]

    def conv(name, cout, cin, k, kind="trunk", bias=False):
        spec[name + ".weight"] = ((cout, cin, k, k), kind)
        if bias:
            spec[name + ".bias"] = ((cout,), "bias")

    def bn(name, c):
        spec[name + ".scale"] = ((c,), "bn_scale")
        spec[name + ".shift"] = ((c,), "bn_shift")

    conv("backbone.conv1", 64, 3, 7)
    bn("backbone.bn1", 64)
    cin = 64
    for s, (blocks, w) in enumerate(zip(STAGES[cfg["backbone"]],
                                        (64, 128, 256, 512))):
        for b in range(blocks):
            p = f"backbone.stage{s + 1}_block{b + 1}"
            conv(p + ".conv1", w, cin, 1)
            bn(p + ".bn1", w)
            conv(p + ".conv2", w, w, 3)
            bn(p + ".bn2", w)
            conv(p + ".conv3", 4 * w, w, 1)
            bn(p + ".bn3", 4 * w)
            if b == 0:
                conv(p + ".conv_proj", 4 * w, cin, 1)
                bn(p + ".bn_proj", 4 * w)
            cin = 4 * w
    c3, c4, c5 = 512, 1024, 2048
    for name, cout, cinn, k in (("c5_reduce", f, c5, 1), ("p5", f, f, 3),
                                ("c4_reduce", f, c4, 1), ("p4", f, f, 3),
                                ("c3_reduce", f, c3, 1), ("p3", f, f, 3),
                                ("p6", f, c5, 3), ("p7", f, f, 3)):
        conv("fpn." + name, cout, cinn, k, bias=True)
    for head, prefix, width, per_anchor in HEADS:
        out = anchors * per_anchor * (1 if prefix == "box" else classes)
        for i in range(4):
            conv(f"{head}.{prefix}_{i}", width, f if i == 0 else width, 3,
                 kind="tower", bias=True)
        conv(f"{head}.{prefix}_out", out, width, 3,
             kind="cls_out" if prefix == "cls" else "tower", bias=True)
    return spec


def same_padding(h: int, w: int, kernel: int, stride: int):
    """((top, bottom), (left, right)) of XLA's SAME padding."""
    pads = []
    for n in (h, w):
        out = -(-n // stride)
        total = max((out - 1) * stride + kernel - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def float_conv(site, x, weight, bias, stride, padding):
    """The float32 conv; padding ((top, bottom), (left, right)) of zeros."""
    (t, b), (l, r) = padding
    return F.conv2d(F.pad(x, (l, r, t, b)), weight, bias, stride=stride)


def forward(weights, images, conv=float_conv):
    """images (B, 3, H, W) float32 -> {"regression", "regression_dim",
    "classification"}, float32."""
    w = weights
    sites = itertools.count()  # conv sites in call order

    def run(name, x, stride=1, pad=None, bias=True):
        k = w[name + ".weight"].shape[-1]
        if pad is None:
            pad = ((k // 2, k // 2), (k // 2, k // 2))
        return conv(next(sites), x, w[name + ".weight"],
                    w.get(name + ".bias") if bias else None, stride, pad)

    def bn(name, x):
        return (x * w[name + ".scale"][:, None, None]
                + w[name + ".shift"][:, None, None])

    stages = []
    i = 1
    while f"backbone.stage{i}_block1.conv1.weight" in w:
        n = 1
        while f"backbone.stage{i}_block{n + 1}.conv1.weight" in w:
            n += 1
        stages.append(n)
        i += 1

    x = run("backbone.conv1", images, 2, ((3, 3), (3, 3)), bias=False)
    x = F.relu(bn("backbone.bn1", x))
    (t, b), (l, r) = same_padding(x.shape[2], x.shape[3], 3, 2)
    x = F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), 3, 2)
    zero = ((0, 0), (0, 0))
    outputs = []
    for s, n in enumerate(stages):
        for blk in range(n):
            p = f"backbone.stage{s + 1}_block{blk + 1}"
            stride = 2 if (blk == 0 and s > 0) else 1
            shortcut = x
            if blk == 0:
                shortcut = bn(p + ".bn_proj", run(p + ".conv_proj", x, stride,
                                                  zero, bias=False))
            y = F.relu(bn(p + ".bn1", run(p + ".conv1", x, stride, zero,
                                          bias=False)))
            y = F.relu(bn(p + ".bn2", run(p + ".conv2", y, bias=False)))
            y = bn(p + ".bn3", run(p + ".conv3", y, 1, zero, bias=False))
            x = F.relu(y + shortcut)
        outputs.append(x)
    c3, c4, c5 = outputs[1], outputs[2], outputs[3]

    def up(x, like):
        return F.interpolate(x, size=like.shape[2:], mode="nearest-exact")

    def same(x):
        return same_padding(x.shape[2], x.shape[3], 3, 2)

    p5_lat = run("fpn.c5_reduce", c5, 1, zero)
    p5 = run("fpn.p5", p5_lat)
    p4_lat = run("fpn.c4_reduce", c4, 1, zero) + up(p5_lat, c4)
    p4 = run("fpn.p4", p4_lat)
    p3_lat = run("fpn.c3_reduce", c3, 1, zero) + up(p4_lat, c3)
    p3 = run("fpn.p3", p3_lat)
    p6 = run("fpn.p6", c5, 2, same(c5))
    p6r = F.relu(p6)
    p7 = run("fpn.p7", p6r, 2, same(p6r))
    features = [p3, p4, p5, p6, p7]

    out = {}
    anchors = w["regression.box_out.weight"].shape[0] // 12
    for head, prefix, _, _ in HEADS:
        maps = []
        for feat in features:
            y = feat
            for i in range(4):
                y = F.relu(run(f"{head}.{prefix}_{i}", y))
            y = run(f"{head}.{prefix}_out", y)
            bsz, ch, h, wd = y.shape
            maps.append(y.permute(0, 2, 3, 1).reshape(
                bsz, h * wd * anchors, ch // anchors).float())
        y = torch.cat(maps, dim=1)
        out[head] = torch.sigmoid(y) if prefix == "cls" else y
    return out


def calibrate(weights, frames, bits: int = 8):
    """Per-site activation scales absmax / (2^(bits-1) - 1) over `frames`
    (a list of (1, 3, H, W) float32 network inputs), the max across
    frames, as the program's absmax calibration defines them."""
    stats = []

    def record(site, x, weight, bias, stride, padding):
        a = x.abs().amax()
        if site == len(stats):
            stats.append(a)
        else:
            stats[site] = torch.maximum(stats[site], a)
        return float_conv(site, x, weight, bias, stride, padding)

    with torch.no_grad():
        for f in frames:
            forward(weights, f, conv=record)
    top = 2 ** (bits - 1) - 1
    return torch.stack(stats).clamp(min=1e-8) / top


def quantized_conv(scales, bits: int = 8):
    """A conv callable for `forward` that runs every site at `bits`:
    x rounded at its site's scale (half to even) and clamped to
    +-(2^(bits-1) - 1), the kernel symmetric per output channel, the
    products summed and rescaled in float32, then the bias."""
    top = 2 ** (bits - 1) - 1
    cache = {}

    def conv(site, x, weight, bias, stride, padding):
        s_x = scales[site]
        key = weight.data_ptr()
        if key not in cache:
            s_w = weight.abs().amax(dim=(1, 2, 3)).clamp(min=1e-8) / top
            cache[key] = (torch.round(weight / s_w[:, None, None, None])
                          .clamp(-top, top), s_w)
        wq, s_w = cache[key]
        xq = torch.round(x / s_x).clamp(-top, top)
        y = float_conv(site, xq, wq, None, stride, padding)
        y = y * (s_x * s_w)[:, None, None]
        return y if bias is None else y + bias[:, None, None]

    return conv


def conv_census(weights, images):
    """[(input shape, weight shape, output shape)] of every conv site of a
    forward on `images` (meta tensors will do: nothing is computed)."""
    sites = []

    def record(site, x, weight, bias, stride, padding):
        y = float_conv(site, x, weight, bias, stride, padding)
        sites.append((tuple(x.shape), tuple(weight.shape), tuple(y.shape)))
        return y

    forward(weights, images, conv=record)
    return sites


def flops_per_frame(cfg) -> float:
    """FLOPs of one frame's forward, by torch's FlopCounterMode on meta
    tensors (convolutions: 2 a multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode

    weights = {k: torch.empty(shape, device="meta")
               for k, (shape, _) in param_spec(cfg).items()}
    images = torch.empty((1, 3, *cfg["canvas"]), device="meta")
    with FlopCounterMode(display=False) as counter:
        forward(weights, images)
    return float(counter.get_total_flops())


def lecun_std(shape) -> float:
    """Standard deviation of lecun_normal for an OIHW kernel."""
    return math.sqrt(1.0 / (shape[1] * shape[2] * shape[3]))
