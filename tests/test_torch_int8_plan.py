"""The int8 conv kernel's launch plan, on the CPU (kernels/int8_conv_cuda.py):
`plan_conv` at every conv site of the full-width detector, a plain split-K
reference that sums the planner's ranges of K back to the whole conv
exactly, the wrapper's refusal of bad plans before it builds, and the
build key of kernels/nvcc_build.py.

The sites come from a meta-device forward of ResNet-50, FPN 512 at
416x1344 (as `count_convs` counts them). The card's slots (blocks of each
tile it holds at once) are those the occupancy API gave on an NVIDIA H100
80GB HBM3 (132 SMs) for this kernel; on the card the wrapper asks the API
itself.
"""

import numpy as np
import pytest
import torch

from ground_plane_polling_tpu_torch.kernels import int8_conv_cuda as ic
from ground_plane_polling_tpu_torch.kernels import nvcc_build
from ground_plane_polling_tpu_torch.models import build_detector
from ground_plane_polling_tpu_torch.models import quantize as tq
from ground_plane_polling_tpu_torch.ops import int8_conv

torch.set_num_threads(2)

H100_SMS = 132
# blocks per SM (shared memory and registers): 4 of the 64 x 48 tile, 3
# of the 64-row tiles 64 and 96 wide, 2 of the wider ones and of every
# 128-row tile
H100_PER_SM = {(64, 48): 4, (64, 64): 3, (64, 96): 3, (64, 128): 2,
               (64, 144): 2, (128, 48): 2, (128, 64): 2, (128, 96): 2,
               (128, 128): 2, (128, 144): 2}
CANVAS = (416, 1344)


def h100_slots():
    assert set(H100_PER_SM) == set(ic.TILES)
    return {tile: H100_SMS * n for tile, n in H100_PER_SM.items()}


def detector_sites(batch, fuse, pack=False):
    """(x shape, w shape, stride, padding) of every conv call of one
    forward, in call order."""
    model = build_detector("resnet50", fuse_cls_dim=fuse,
                           pack_levels=pack).to("meta")
    sites = []

    def record(site, conv, x):
        sites.append((tuple(x.shape), tuple(conv.weight.shape),
                      conv.stride[0], tq.conv_padding(conv, x)))
        return tq._float_conv(site, conv, x)

    with torch.no_grad(), tq._intercept(model, record):
        model(torch.empty(batch, 3, *CANVAS, device="meta"))
    return sites


def site_gemm(site):
    """(M, N, K) of a conv site."""
    (b, c, h, w), (o, _, kh, kw), stride, ((top, bottom), (left, right)) = site
    ho = (h + top + bottom - kh) // stride + 1
    wo = (w + left + right - kw) // stride + 1
    return b * ho * wo, o, c * kh * kw


def assert_plan_valid(site, slots):
    """The checks of the test below on one site's plan; returns its
    splits."""
    m, n, k = site_gemm(site)
    bm, bn, splits = ic.plan_conv(m, n, k, slots, H100_SMS)
    assert (bm, bn) in ic.TILES, site
    assert bn == (min(w for w in ic.WIDTHS if w >= n) if n <= 144
                  else 128), site
    steps = -(-k // ic.K_STEP)
    ranges = ic.split_ranges(steps, splits)
    assert len(ranges) == splits, site
    assert ranges[0][0] == 0 and ranges[-1][1] == steps, site
    assert all(a < b for a, b in ranges), site
    assert all(r[1] == s[0] for r, s in zip(ranges, ranges[1:])), site
    if splits > 1:
        assert all(b - a >= ic.MIN_SPLIT_STEPS for a, b in ranges[:-1])
    tiles = -(-m // bm) * -(-n // bn)
    # a grid smaller than the card holds at once is split until every
    # SM has a block, unless K runs out of splits
    if tiles < slots[(bm, bn)]:
        assert (tiles * splits >= H100_SMS
                or splits == ic.split_counts(steps)[-1]), (site, splits)
    else:
        assert splits == 1, site
    partials, counters = ic.workspace_size(m, n, (bm, bn, splits))
    if splits == 1:
        assert (partials, counters) == (0, 0)
    else:
        assert counters == tiles
        assert partials == tiles * splits * bm * bn < 2**31
    return splits


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("fuse", [False, True], ids=["split", "fused"])
def test_plan_is_valid_at_every_detector_site(batch, fuse):
    """Every site gets a compiled tile whose width holds the channels
    (or 128 above 144), splits that cut K into non-empty ranges of
    at least MIN_SPLIT_STEPS steps (the last may be shorter), enough blocks
    for one wave of the card unless K runs out of steps, and a workspace
    that fits int32 indexing."""
    sites = detector_sites(batch, fuse)
    assert len(sites) == (111 if fuse else 136)
    slots = h100_slots()
    split_sites = sum(assert_plan_valid(site, slots) > 1 for site in sites)
    # the small grids of layer4 and P5-P7 are the ones split
    assert split_sites >= (40 if batch == 1 else 20)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("fuse", [False, True], ids=["split", "fused"])
def test_plan_is_valid_at_every_packed_site(batch, fuse):
    """build_detector(pack_levels=True): 91 sites (81 fused), whose head
    towers run on P3 and on the 26 x 127 canvas of P4..P7 at 416x1344 (M
    = 26 127 B rows): each plan as valid as the unpacked ones."""
    sites = detector_sites(batch, fuse, pack=True)
    assert len(sites) == (81 if fuse else 91)
    tail = [s for s in sites if s[0][2:] == (26, 127)]
    assert len(tail) == (10 if fuse else 15)
    slots = h100_slots()
    for site in sites:
        assert_plan_valid(site, slots)


def test_plan_examples_on_the_h100():
    """The sites the plan was made for: P6's 3x3 s2 conv over 2,048
    channels splits K until every SM has a block; the P3 box tower fills
    the card unsplit; the heads' outputs and layer1 take their own
    widths."""
    slots = h100_slots()

    def plan(m, n, k):
        return ic.plan_conv(m, n, k, slots, H100_SMS)

    p6 = plan(7 * 21, 512, 9 * 2048)
    assert p6[0] == 64 and p6[2] >= 8
    assert -(-147 // 64) * 512 // p6[1] * p6[2] >= H100_SMS
    assert plan(52 * 168, 512, 9 * 512)[2] == 1
    assert plan(52 * 168, 36, 9 * 128)[1] == 48
    assert plan(52 * 168, 96, 9 * 256)[1] == 96
    assert plan(52 * 168, 144, 9 * 512)[1] == 144
    assert plan(104 * 336, 64, 9 * 64)[1:] == (64, 1)
    # one K step cannot split
    assert plan(1, 8, 48)[2] == 1


@pytest.mark.parametrize("steps", [1, 2, 5, 7, 36, 144])
def test_split_ranges_match_the_kernel(steps):
    """split_ranges is the kernel's own cut (per = ceil(steps / splits),
    ceil(steps / per) ranges), and a normalized count cuts to itself."""
    for splits in range(1, steps + 1):
        ranges = ic.split_ranges(steps, splits)
        per = -(-steps // splits)
        assert len(ranges) == -(-steps // per)
        assert ranges == [(z * per, min(steps, (z + 1) * per))
                          for z in range(len(ranges))]
        assert len(ic.split_ranges(steps, len(ranges))) == len(ranges)


# (cin, cout, kernel, stride, padding, h, w)
SPLIT_CASES = {
    "3x3_cin64": (64, 24, 3, 1, ((1, 1), (1, 1)), 6, 9),
    "p6_like_3x3_s2_same": (256, 16, 3, 2, ((1, 1), (0, 1)), 7, 11),
    "1x1_cin512": (512, 8, 1, 1, ((0, 0), (0, 0)), 5, 6),
    "stem_like_cin3": (3, 8, 7, 2, ((3, 3), (3, 3)), 20, 24),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_k_partials_sum_to_the_conv(case):
    """A plain split-K reference: the int8 conv restricted to each of the
    planner's ranges of K ([kh][kw][Cin] order, K_STEP bytes a step) adds
    up, in int32, to the whole conv exactly, for every split count."""
    cin, cout, kk, stride, pad, h, w = SPLIT_CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    x8 = torch.from_numpy(rng.randint(-127, 128, (2, cin, h, w)).astype(
        np.int8))
    w8 = torch.from_numpy(rng.randint(-127, 128, (cout, cin, kk, kk)).astype(
        np.int8))
    whole = int8_conv.conv2d_int8(x8, w8, stride, pad)
    k = cin * kk * kk
    steps = -(-k // ic.K_STEP)
    # K index of each weight element in the kernel's [Cout][kh][kw][Cin]
    kidx = torch.arange(k).reshape(kk, kk, cin).permute(2, 0, 1)
    for splits in sorted({1, 2, steps}):
        total = torch.zeros_like(whole)
        for begin, end in ic.split_ranges(steps, splits):
            inside = ((kidx >= begin * ic.K_STEP)
                      & (kidx < end * ic.K_STEP)).to(torch.int8)
            total += int8_conv.conv2d_int8(x8, w8 * inside, stride, pad)
        assert torch.equal(total, whole), splits


@pytest.mark.parametrize("plan", [(96, 64, 1), (64, 40, 1), (64, 64, 0),
                                  (128, 128, 6)],
                         ids=["bm96", "bn40", "splits0", "splits_past_k"])
def test_wrapper_refuses_bad_plans_before_building(plan):
    """A forced plan with a tile that is not compiled, or a split count
    outside 1 to ceil(K / K_STEP), is refused before the wrapper builds or
    launches anything (CPU tensors: a good plan gets to the device check)."""
    x8 = torch.zeros(1, 4, 4, 64, dtype=torch.int8).permute(0, 3, 1, 2)
    w8 = torch.zeros(8, 3, 3, 64, dtype=torch.int8).permute(0, 3, 1, 2)
    before = ic.CONV_LAUNCHES
    args = [x8, w8, 0.0, None, None, 1, ((1, 1), (1, 1)), torch.int32]
    with pytest.raises(ValueError, match="plan"):
        ic._launch(*args, plan=plan)
    with pytest.raises(ValueError, match="CUDA device"):
        ic._launch(*args, plan=(64, 64, 5))
    assert ic.CONV_LAUNCHES == before


def test_wrapper_refuses_empty_reduction():
    """Zero input channels leave K empty: refused, not launched."""
    x8 = torch.zeros(1, 4, 4, 0, dtype=torch.int8).permute(0, 3, 1, 2)
    w8 = torch.zeros(8, 3, 3, 0, dtype=torch.int8).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="channels"):
        ic._launch(x8, w8, 0.0, None, None, 1, ((1, 1), (1, 1)),
                   torch.int32)


def test_build_key_covers_headers_and_flags(tmp_path):
    """The library's key changes with the source, with a header it
    includes (transitively, quoted or from an -I directory) and with the
    flags, and not with a header it does not include."""
    (tmp_path / "inc").mkdir()
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n'
                   '#include <lib.cuh>\nint main() {}\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "c.cuh").write_text("// not included\n")
    (tmp_path / "inc" / "lib.cuh").write_text("// lib\n")
    flags = ("-O3", "-I", str(tmp_path / "inc"))
    names = [p.name for p in nvcc_build.sources_of(src, flags)]
    assert names == ["k.cu", "a.cuh", "lib.cuh", "b.cuh"]
    key = nvcc_build.build_key(src, flags)
    assert nvcc_build.build_key(src, flags) == key
    (tmp_path / "c.cuh").write_text("// still not included\n")
    assert nvcc_build.build_key(src, flags) == key
    for edit in ("b.cuh", "inc/lib.cuh", "k.cu"):
        (tmp_path / edit).write_text((tmp_path / edit).read_text() + "//\n")
        new = nvcc_build.build_key(src, flags)
        assert new != key, edit
        key = new
    assert nvcc_build.build_key(src, flags[:1]) != key
    # without the -I directory its header is not found, so not hashed
    assert [p.name for p in nvcc_build.sources_of(src, ("-O3",))] == [
        "k.cu", "a.cuh", "b.cuh"]


def test_int8_kernel_sources_include_the_wgmma_header():
    """The conv kernel's library is keyed on its wgmma header too."""
    names = [p.name for p in nvcc_build.sources_of(ic.SOURCE,
                                                   ic.NVCC_FLAGS)]
    assert names == ["int8_conv.cu", "wgmma_s8.cuh"]
