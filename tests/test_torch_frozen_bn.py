"""The frozen BN, residual add and ReLU of the port's ResNet sites
(models/common.py::frozen_bn_act, kernels/frozen_bn_cuda.py,
csrc/frozen_bn.cu).

On the CPU: the dispatch takes the plain expression for a CPU tensor of
any layout, C or dtype, and for a grad-enabled forward, and then computes
exactly the expressions ResNet's blocks wrote before the kernel (`_before`
below): the sites, a shrunk trunk and a bottleneck's gradients, bit for
bit. Outside autograd it hands the kernel's wrapper the BN's buffers in the
map's type; on a card's map (a CPU tensor that says it is on the card,
`_OnCard`) the wrapper launches the kernel, or raises on a map it does not
take (another layout, C or dtype, a residual unlike the map), and never
falls back to the plain passes.

On the card (`gpu` marker; skips without one): the kernel bit for bit
against the plain passes at every trunk site's shape, float32 and bf16,
with seeded non-identity BN (negative scales and shifts; the detector's
seeded weights use identity BN, which would hide a wrong rounding order),
ResNet-50's trunk and an int8 forward fused against plain, one launch a
site, the captured call against its eager form, and the captured graph's
kernel nodes. The file imports nothing of JAX:

    python -m pytest tests/test_torch_frozen_bn.py --noconftest -m gpu -q
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ground_plane_polling_tpu_torch.kernels import frozen_bn_cuda
from ground_plane_polling_tpu_torch.models import resnet
from ground_plane_polling_tpu_torch.models.common import (FrozenBatchNorm,
                                                          frozen_bn_act)

VARIANTS = ("affine", "relu", "identity", "projected")
DTYPES = (torch.float32, torch.bfloat16)


def _bn(channels, gen, dtype=torch.float32):
    """A FrozenBatchNorm with seeded non-identity scale and shift: scales
    in [-0.5, 1.5) (some negative), shifts N(0, 0.25)."""
    bn = FrozenBatchNorm(channels)
    bn.scale.copy_(torch.rand(channels, generator=gen) * 2.0 - 0.5)
    bn.shift.copy_(torch.randn(channels, generator=gen) * 0.25)
    return bn.to(dtype)


def seed_bn(model, seed):
    """Every FrozenBatchNorm of `model` redrawn as `_bn` draws it."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, FrozenBatchNorm):
            fresh = _bn(m.scale.numel(), gen)
            m.scale.copy_(fresh.scale)
            m.shift.copy_(fresh.shift)
    return model


def _before(x, bn, relu, residual=None, residual_bn=None):
    """The expressions of models/common.py::FrozenBatchNorm and
    models/resnet.py before the kernel: BN as x * scale + shift in x's type,
    the projection's BN on its conv's output, y + shortcut, F.relu."""
    def affine(t, m):
        return (t * m.scale.to(t.dtype)[:, None, None]
                + m.shift.to(t.dtype)[:, None, None])

    y = affine(x, bn)
    if residual is not None:
        shortcut = (affine(residual, residual_bn) if residual_bn is not None
                    else residual)
        return F.relu(y + shortcut)
    return F.relu(y) if relu else y


def _case(variant, dtype, shape=(2, 16, 5, 7), seed=0, device="cpu",
          channels_last=True):
    """(x, bn, relu, residual, residual_bn) of one site: N(0, 1) inputs."""
    gen = torch.Generator().manual_seed(seed)
    fmt = torch.channels_last if channels_last else torch.contiguous_format

    def tensor():
        t = torch.randn(shape, generator=gen).to(dtype)
        return t.to(device).contiguous(memory_format=fmt)

    x, c = tensor(), shape[1]
    bn = _bn(c, gen, dtype).to(device)
    relu = variant != "affine"
    residual = tensor() if variant in ("identity", "projected") else None
    residual_bn = _bn(c, gen, dtype).to(device) \
        if variant == "projected" else None
    return x, bn, relu, residual, residual_bn


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _assert_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a card: the dispatch's predicate
    sees what it would see of a card's map."""

    @property
    def is_cuda(self):
        return True


def _on_card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


def _no_kernel(*args, **kwargs):
    raise AssertionError("the kernel was launched")


def _spy_launch(monkeypatch):
    """Stands in for the kernel's launch: records it and writes the plain
    passes' output. Returns the list of launches."""
    launched = []

    def launch(x, s, b, relu, r, sp, bp, out):
        launched.append(x.shape)
        out.copy_(frozen_bn_cuda.plain(x, s, b, relu, r, sp, bp))

    monkeypatch.setattr(frozen_bn_cuda, "_launch", launch)
    return launched


# --- on the CPU: the dispatch ------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("variant", VARIANTS)
def test_cpu_site_is_the_expression_before_the_kernel(monkeypatch, variant,
                                                      dtype):
    """A CPU map takes the plain passes, bit for bit the expressions before
    the kernel, under inference mode too; the kernel is never launched."""
    monkeypatch.setattr(frozen_bn_cuda, "_launch", _no_kernel)
    x, bn, relu, r, rbn = _case(variant, dtype)
    with torch.inference_mode():
        got = frozen_bn_act(x, bn, relu, r, rbn)
    _assert_bits(got, _before(x, bn, relu, r, rbn))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_wrapper_on_the_cpu_is_its_plain_version(variant, dtype):
    """frozen_bn_cuda.frozen_bn_act on CPU tensors runs `plain`: the same
    bits as the expressions before the kernel, with the BN buffers in the
    map's type."""
    x, bn, relu, r, rbn = _case(variant, dtype, seed=1)
    before = frozen_bn_cuda.BN_ACT_LAUNCHES
    got = frozen_bn_cuda.frozen_bn_act(
        x, bn.scale, bn.shift, relu, r,
        None if rbn is None else rbn.scale,
        None if rbn is None else rbn.shift)
    assert frozen_bn_cuda.BN_ACT_LAUNCHES == before
    _assert_bits(got, _before(x, bn, relu, r, rbn))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("variant", VARIANTS)
def test_fusable_site_hands_the_kernel_the_bn_in_the_maps_type(
        monkeypatch, variant, dtype):
    """Where the predicate holds, the site is one kernel call, given x, the
    BN's scale and shift in x's type, the ReLU flag and the shortcut with
    its BN's; its output is what the kernel returns."""
    calls = []

    def kernel(x, s, b, relu, r=None, sp=None, bp=None):
        calls.append((s, b, relu, r, sp, bp))
        return frozen_bn_cuda.plain(x, s, b, relu, r, sp, bp)

    monkeypatch.setattr(frozen_bn_cuda, "frozen_bn_act", kernel)
    x, bn, relu, r, rbn = _case(variant, dtype, seed=2)
    bn.float()  # float32 buffers: the dispatch casts them to x's type
    with torch.inference_mode():
        got = frozen_bn_act(_on_card(x), bn, relu,
                            None if r is None else _on_card(r), rbn)
    ((s, b, flag, rr, sp, bp),) = calls
    assert flag == relu and s.dtype == b.dtype == dtype
    assert torch.equal(s, bn.scale.to(dtype))
    assert torch.equal(b, bn.shift.to(dtype))
    assert (rr is None) == (r is None)
    if rbn is None:
        assert sp is None and bp is None
    else:
        assert torch.equal(sp, rbn.scale) and torch.equal(bp, rbn.shift)
    _assert_bits(got.as_subclass(torch.Tensor), _before(x, bn, relu, r, rbn))


def _predicate_case(name):
    gen = torch.Generator().manual_seed(3)
    shape, dtype, fmt = (2, 16, 5, 7), torch.bfloat16, torch.channels_last
    residual = None
    if name == "nchw":
        fmt = torch.contiguous_format
    elif name == "c12":
        shape = (2, 12, 5, 7)
    elif name in ("float16", "float64"):
        dtype = getattr(torch, name)
    elif name == "too_many_channels":
        shape = (1, frozen_bn_cuda.MAX_CHANNELS + 8, 1, 2)
    elif name == "three_dims":
        shape = (16, 5, 7)
    x = torch.randn(shape, generator=gen).to(dtype)
    if x.dim() == 4:
        x = x.contiguous(memory_format=fmt)
    if name == "residual_nchw":
        residual = torch.randn(shape, generator=gen).to(dtype)
    elif name == "residual_float32":
        residual = torch.randn(shape, generator=gen).contiguous(
            memory_format=fmt)
    elif name in ("fusable_with_residual", "grad_with_residual"):
        residual = torch.randn(shape, generator=gen).to(dtype).contiguous(
            memory_format=fmt)
    if name == "cpu":
        return x, residual
    return _on_card(x), None if residual is None else _on_card(residual)


@pytest.mark.parametrize("name,grad,want", [
    ("fusable", False, True),
    ("fusable_with_residual", False, True),
    ("grad", True, False),
    ("grad_with_residual", True, False),
    ("cpu", False, False),
    ("nchw", False, False),
    ("c12", False, False),
    ("float16", False, False),
    ("float64", False, False),
    ("too_many_channels", False, False),
    ("three_dims", False, False),
    ("residual_nchw", False, False),
    ("residual_float32", False, False),
])
def test_dispatch_predicate(monkeypatch, name, grad, want):
    """The kernel launches (`want`) on a card's map outside autograd that
    it takes (float32 or bf16, 4-D, channels-last, C a multiple of 8 up to
    MAX_CHANNELS) with a residual of the map's type and strides. A CPU map
    and a grad-enabled forward take the plain passes; any other card map
    outside autograd raises, and the plain passes never stand in."""
    launched = _spy_launch(monkeypatch)
    x, residual = _predicate_case(name)
    bn = _bn(x.shape[-3], torch.Generator().manual_seed(4), x.dtype)
    with torch.set_grad_enabled(grad):
        if not (want or grad or name == "cpu"):
            with pytest.raises(ValueError):
                frozen_bn_act(x, bn, True, residual)
            assert launched == []
            return
        got = frozen_bn_act(x, bn, True, residual)
    assert len(launched) == int(want)
    plain = [None if t is None else t.as_subclass(torch.Tensor)
             for t in (x, residual)]
    _assert_bits(got.as_subclass(torch.Tensor),
                 _before(plain[0], bn, True, plain[1]))


@pytest.mark.parametrize("name", ["grad", "nchw", "c12"])
def test_unfusable_card_map_takes_the_plain_passes(monkeypatch, name):
    """A card's map under autograd (the kernel has no backward) runs the
    expressions before the kernel; one outside autograd that the kernel
    does not take (NCHW memory, C not a multiple of 8) raises rather than
    take them. The kernel is never launched."""
    monkeypatch.setattr(frozen_bn_cuda, "_launch", _no_kernel)
    x, _ = _predicate_case(name)
    bn = _bn(x.shape[1], torch.Generator().manual_seed(4), x.dtype)
    if name != "grad":
        with torch.no_grad(), pytest.raises(ValueError):
            frozen_bn_act(x, bn, relu=True)
        return
    got = frozen_bn_act(x, bn, relu=True)
    _assert_bits(got.as_subclass(torch.Tensor).detach(),
                 _before(x.as_subclass(torch.Tensor), bn, True).detach())


def _refused_case(name):
    """(x, s, b, relu, r, sp, bp) of a card's site that the wrapper
    refuses."""
    x, bn, _, r, rbn = _case("projected", torch.bfloat16, seed=11)
    x, r = _on_card(x), _on_card(r)
    s, b, sp, bp = bn.scale, bn.shift, rbn.scale, rbn.shift
    if name == "residual_without_relu":
        return x, s, b, False, r, sp, bp
    if name == "sp_without_bp":
        return x, s, b, True, r, sp, None
    if name == "projection_without_shortcut":
        return x, s, b, True, None, sp, bp
    if name == "float32_scale":
        return x, s.float(), b, True, r, sp, bp
    if name == "residual_of_another_shape":
        return x, s, b, True, r[:1], sp, bp
    assert name == "requires_grad"
    return x, s.clone().requires_grad_(True), b, True, r, sp, bp


@pytest.mark.parametrize("name", [
    "residual_without_relu", "sp_without_bp", "projection_without_shortcut",
    "float32_scale", "residual_of_another_shape", "requires_grad"])
def test_wrapper_refuses_a_card_site_it_does_not_take(monkeypatch, name):
    """On a card's tensors the wrapper raises, and launches nothing, for a
    shortcut without its ReLU (no such site: the kernel has no instance
    for it), a projection's BN half given or without a shortcut, BN
    vectors of another type, a shortcut of another shape, and a tensor
    that requires grad under autograd (the kernel has no backward)."""
    monkeypatch.setattr(frozen_bn_cuda, "_launch", _no_kernel)
    with pytest.raises(ValueError):
        frozen_bn_cuda.frozen_bn_act(*_refused_case(name))


@pytest.mark.parametrize("project", [False, True])
def test_bottleneck_gradients_unchanged(monkeypatch, project):
    """A training step's forward and backward through a bottleneck block
    (grad enabled: the plain passes) gives the outputs and the gradients
    of the block as written before the kernel, bit for bit, for the input
    and every conv weight."""
    torch.manual_seed(5)
    cin, filters = (16, 8) if project else (32, 8)
    block = resnet.BottleneckBlock(cin, filters, 2 if project else 1,
                                   project)
    seed_bn(block, 5)
    x = torch.randn(2, cin, 9, 11)
    weight = torch.randn(2, 4 * filters, *(5, 6) if project else (9, 11))

    def step(forward):
        xx = x.clone().requires_grad_(True)
        block.zero_grad()
        out = forward(xx)
        (out * weight).sum().backward()
        return [out.detach(), xx.grad] + [
            p.grad.clone() for p in block.parameters()]

    def written_before(xx):
        b = block
        shortcut = xx
        if b.conv_proj is not None:
            shortcut = b.bn_proj(b.conv_proj(xx))
        y = F.relu(b.bn1(b.conv1(xx)))
        y = F.relu(b.bn2(b.conv2(y)))
        y = b.bn3(b.conv3(y))
        return F.relu(y + shortcut)

    monkeypatch.setattr(frozen_bn_cuda, "_launch", _no_kernel)
    for got, want in zip(step(block), step(written_before)):
        _assert_bits(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cpu_trunk_is_the_trunk_before_the_kernel(monkeypatch, dtype):
    """A shrunk ResNet trunk (one block a stage) with seeded non-identity
    BN under inference mode on the CPU: C3, C4, C5 bit for bit those of the
    same trunk with every site written as before the kernel."""
    torch.manual_seed(6)
    trunk = seed_bn(resnet.ResNetBackbone((1, 1, 1, 1)), 6).to(dtype).eval()
    x = torch.randn(2, 3, 64, 96).to(dtype)
    monkeypatch.setattr(frozen_bn_cuda, "_launch", _no_kernel)
    with torch.inference_mode():
        got = trunk(x)
        monkeypatch.setattr(resnet, "frozen_bn_act", _before)
        want = trunk(x)
    for g, w in zip(got, want):
        assert g.abs().max() > 0 and torch.isfinite(g).all()
        _assert_bits(g, w)


@pytest.mark.parametrize("shape,dtype,fmt,want", [
    ((2, 64, 13, 42), torch.bfloat16, "cl", True),
    ((1, 2048, 13, 42), torch.float32, "cl", True),
    ((1, 8, 1, 1), torch.float32, "cl", True),
    ((1, 24, 3, 5), torch.bfloat16, "cl", True),
    ((1, 64, 13, 42), torch.bfloat16, "nchw", False),
    ((1, 20, 13, 42), torch.bfloat16, "cl", False),
    ((1, 64, 13, 42), torch.float16, "cl", False),
    ((1, 3080, 1, 2), torch.float32, "cl", False),
], ids=str)
def test_supports(shape, dtype, fmt, want):
    """The layouts and types the kernel takes."""
    x = torch.zeros(shape, dtype=dtype)
    if fmt == "cl":
        x = x.contiguous(memory_format=torch.channels_last)
    assert frozen_bn_cuda.supports(x) is want


def test_supports_refuses_a_misaligned_map():
    """A channels-last map 4 bytes into its storage: no 16-byte vectors."""
    x = torch.zeros(1 + 2 * 2 * 8)[1:].view(1, 2, 2, 8).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert not frozen_bn_cuda.supports(x)
    assert frozen_bn_cuda.supports(x.clone(
        memory_format=torch.channels_last))


def test_launch_counter_is_counted_by_the_captured_call():
    """The captured detect call counts the kernel's launches a replay."""
    from ground_plane_polling_tpu_torch.inference import LAUNCH_COUNTERS

    assert (frozen_bn_cuda, "BN_ACT_LAUNCHES") in LAUNCH_COUNTERS


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def exact_convs(cuda):
    """float32 convs in float32 and cuDNN's deterministic algorithms,
    restored after: two forwards of one trunk then see the same conv
    outputs."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def _plain_passes(monkeypatch):
    """Every site of what runs next takes the plain passes, as before the
    kernel."""
    monkeypatch.setattr(frozen_bn_cuda, "frozen_bn_act", frozen_bn_cuda.plain)


def _kernel_against_plain(x, bn, relu, r, rbn):
    before = frozen_bn_cuda.BN_ACT_LAUNCHES
    with torch.inference_mode():
        got = frozen_bn_act(x, bn, relu, r, rbn)
    assert frozen_bn_cuda.BN_ACT_LAUNCHES == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    _assert_bits(got, _before(x, bn, relu, r, rbn))


# the trunk's map sizes at 416x1344 (stage 1 to 4) and every C of its sites
TRUNK_SIZES = ((104, 336), (52, 168), (26, 84), (13, 42))
TRUNK_CHANNELS = (64, 256, 512, 1024, 2048)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", TRUNK_SIZES, ids=str)
@pytest.mark.parametrize("c", TRUNK_CHANNELS)
def test_kernel_bit_equal_at_trunk_shapes(cuda, c, hw):
    """Every variant in float32 and bf16 at a trunk map size and C, seeded
    non-identity BN: the kernel's bits are the plain passes'."""
    for dtype in DTYPES:
        for i, variant in enumerate(VARIANTS):
            _kernel_against_plain(*_case(variant, dtype, (1, c, *hw),
                                         seed=c + i, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (1, 64, 208, 672),   # the stem's output at 416x1344
    (4, 64, 208, 672),   # at b4
    (4, 2048, 13, 42),   # stage 4 at b4
    (2, 8, 3, 5),        # the fewest channels: 15 bf16 vectors
    (3, 24, 7, 9),       # C not a power of two
    (2, 3072, 2, 3),     # MAX_CHANNELS
    (1, 40, 1, 1),
], ids=str)
def test_kernel_bit_equal_at_other_shapes(cuda, shape):
    for dtype in DTYPES:
        for i, variant in enumerate(VARIANTS):
            _kernel_against_plain(*_case(variant, dtype, shape, seed=i,
                                         device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_bit_equal_on_special_values(cuda, variant, dtype):
    """Infinities, NaN, signed zeros, subnormals and products past the
    type's range, in the maps and in the BN: the same bits."""
    special = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0,
                            -0.0, 1e-40, -1e-40, 3e38, -3e38, 1.0, -1.0,
                            1e-30, 65504.0, 2.0**-126, -(2.0**-133), 7.0])
    x, bn, relu, r, rbn = _case(variant, dtype, (2, 16, 4, 6), seed=7,
                                device=cuda)
    gen = torch.Generator().manual_seed(7)
    for t in (x, r):
        if t is not None:
            flat = t.permute(0, 2, 3, 1).reshape(-1)
            pick = torch.randint(0, special.numel(), (flat.numel() // 3,),
                                 generator=gen)
            where = torch.randperm(flat.numel(), generator=gen)[:pick.numel()]
            flat[where.to(cuda)] = special[pick].to(dtype).to(cuda)
    for m in (bn, rbn):
        if m is not None:
            m.scale[:special.numel()] = special.to(dtype).to(cuda)
            m.shift[3:3 + special.numel() // 2] = special[::2].to(dtype).to(
                cuda)
    _kernel_against_plain(x, bn, relu, r, rbn)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    x, bn, relu, r, rbn = _case("projected", torch.bfloat16, (1, 16, 3, 4),
                                device=cuda)
    with pytest.raises(ValueError):
        frozen_bn_cuda.frozen_bn_act(x.contiguous(), bn.scale, bn.shift, True)
    with pytest.raises(ValueError):
        frozen_bn_cuda.frozen_bn_act(x, bn.scale.float(), bn.shift, True)
    with pytest.raises(ValueError):
        frozen_bn_cuda.frozen_bn_act(x, bn.scale, bn.shift, True,
                                     r.contiguous(), rbn.scale, rbn.shift)
    with pytest.raises(ValueError):
        frozen_bn_cuda.frozen_bn_act(x, bn.scale, bn.shift, True, r,
                                     rbn.scale, None)
    with pytest.raises(ValueError):
        frozen_bn_cuda.frozen_bn_act(x, bn.scale, bn.shift, False, r,
                                     rbn.scale, rbn.shift)
    with pytest.raises(ValueError):
        frozen_bn_cuda.frozen_bn_act(x.requires_grad_(True), bn.scale,
                                     bn.shift, True)


def _trunk(dtype, device, seed=8):
    trunk = seed_bn(resnet.ResNetBackbone(), seed)
    return trunk.to(device=device, dtype=dtype).eval().to(
        memory_format=torch.channels_last)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_resnet50_trunk_fused_equals_plain(cuda, exact_convs, monkeypatch,
                                           dtype):
    """ResNet-50's trunk at a 128x416 canvas, b2, seeded non-identity BN:
    C3, C4, C5 of the fused sites bit for bit those of the plain passes;
    49 launches a forward, one a site."""
    trunk = _trunk(dtype, cuda)
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(2, 3, 128, 416, generator=gen).to(cuda).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        before = frozen_bn_cuda.BN_ACT_LAUNCHES
        got = trunk(x)
        assert frozen_bn_cuda.BN_ACT_LAUNCHES == before + 49
        _plain_passes(monkeypatch)
        want = trunk(x)
        assert frozen_bn_cuda.BN_ACT_LAUNCHES == before + 49
    for g, w in zip(got, want):
        assert g.abs().max() > 0 and torch.isfinite(g).all()
        _assert_bits(g, w)


def _detector(device, dtype=torch.bfloat16, seed=9):
    from ground_plane_polling_tpu_torch.inference import place_model
    from ground_plane_polling_tpu_torch.models import (build_detector,
                                                       init_detector)

    model = init_detector(build_detector("resnet50"), 0)
    out = model.classification.cls_out
    with torch.no_grad():
        out.weight.copy_(torch.randn(out.weight.shape,
                                     generator=torch.Generator()
                                     .manual_seed(0)) * 0.05)
    return place_model(seed_bn(model, seed), device, dtype)


def _detect_args(b, canvas, device, seed=0):
    from ground_plane_polling_tpu_torch.kernels import polling_cases

    rng = np.random.RandomState(seed)
    P = np.array([[721.5, 0.0, 609.6, 44.9], [0.0, 721.5, 172.9, 0.2],
                  [0.0, 0.0, 1.0, 0.003]])
    planes = polling_cases.random_case(rng, b, 1, 1000)[-1]
    return (torch.from_numpy(rng.randint(0, 256, (b, *canvas, 3)).astype(
                np.uint8)).to(device),
            torch.from_numpy(np.tile(np.linalg.pinv(P)[None], (b, 1, 1))
                             .astype(np.float32)).to(device),
            torch.from_numpy(np.asarray(planes, np.float32)).to(device))


def _numpy(out):
    return {k: v.cpu().numpy() for k, v in out._asdict().items()
            if v is not None}


def _assert_outputs_equal(got, want):
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.gpu
def test_int8_forward_fused_equals_plain(cuda, monkeypatch):
    """bf16 detector, seeded non-identity BN, at 128x416: the calibration
    scales and the int8 QuantizedModel's head outputs are bit for bit the
    plain passes'."""
    from ground_plane_polling_tpu_torch.models.quantize import (
        collect_scales, quantize_apply)

    torch.backends.cudnn.deterministic, was = True, \
        torch.backends.cudnn.deterministic
    try:
        model = _detector(cuda)
        gen = torch.Generator().manual_seed(10)
        images = [torch.randn(2, 3, 128, 416, generator=gen).mul(40.0).to(
            cuda)]
        runs = []
        for fused in (True, False):
            if not fused:
                _plain_passes(monkeypatch)
            scales = collect_scales(model, images)
            before = frozen_bn_cuda.BN_ACT_LAUNCHES
            with torch.inference_mode():
                out = quantize_apply(model, scales)(images[0])
            launched = frozen_bn_cuda.BN_ACT_LAUNCHES - before
            runs.append((scales, {k: o.float().cpu()
                                  for k, o in out.items()}, launched))
        (s1, o1, n1), (s0, o0, n0) = runs
        assert (n1, n0) == (49, 0)
        np.testing.assert_array_equal(s1, s0)
        assert o1.keys() == o0.keys()
        for key in o0:
            assert torch.equal(o1[key], o0[key]), key
    finally:
        torch.backends.cudnn.deterministic = was


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_captured_call_with_fused_sites(cuda, exact_convs, monkeypatch,
                                        dtype):
    """A captured detect call (b2, 128x416, pose on, seeded non-identity
    BN): each replay equals detect.eager and the plain passes' eager call
    bit for bit, and counts 49 launches of the kernel."""
    from ground_plane_polling_tpu_torch.inference import make_detect_fn

    canvas = (128, 416)
    model = _detector(cuda, dtype)
    args = _detect_args(2, canvas, cuda)
    detect = make_detect_fn(model, canvas, with_pose=True,
                            device_preprocess=True)
    want = _numpy(detect.eager(*args))
    assert (want["scores"] > 0).any()
    detect(*args)
    before = frozen_bn_cuda.BN_ACT_LAUNCHES
    got = _numpy(detect(*args))
    assert frozen_bn_cuda.BN_ACT_LAUNCHES == before + 49
    _assert_outputs_equal(got, want)
    _plain_passes(monkeypatch)
    _assert_outputs_equal(_numpy(detect.eager(*args)), want)


@pytest.mark.gpu
def test_captured_graph_has_122_fewer_kernel_nodes(cuda, monkeypatch,
                                                   tmp_path):
    """The b1 captured call's graph (cudaGraphDebugDotPrint) with the fused
    sites holds 122 kernel nodes fewer than with the plain passes (171
    elementwise passes become 49 launches), 49 of them the kernel's."""
    from ground_plane_polling_tpu_torch.inference import make_detect_fn

    real = torch.cuda.CUDAGraph

    def debugged():
        graph = real(keep_graph=True)
        graph.enable_debug_mode()
        return graph

    monkeypatch.setattr(torch.cuda, "CUDAGraph", debugged)
    monkeypatch.delenv("GPP_TRACE", raising=False)
    canvas = (128, 416)
    model = _detector(cuda)
    args = _detect_args(1, canvas, cuda)
    counts = []
    for fused in (True, False):
        if not fused:
            _plain_passes(monkeypatch)
        detect = make_detect_fn(model, canvas, with_pose=True,
                                device_preprocess=True)
        detect(*args)
        (g,) = detect.graphs.values()
        path = tmp_path / f"graph{int(fused)}.dot"
        g.graph.debug_dump(str(path))
        dot = path.read_text()
        counts.append((dot.count('label="{KERNEL'),
                       dot.count("frozen_bn_kernel")))
    (k1, f1), (k0, f0) = counts
    assert (k0 - k1, f1, f0) == (122, 49, 0), counts
