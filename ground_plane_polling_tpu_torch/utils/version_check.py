"""Dependency version guard (port of ground_plane_polling_tpu/utils/
version_check.py): the torch version, and on a CUDA device the CUDA build
and the card's compute capability. Every kernel of the port is compiled
for sm_90a (Hopper: wgmma, which only compute capability 9.0 runs)."""

from __future__ import annotations

# torch.nn.init's `generator` argument (the seeded init of
# models/weights.py) came with torch 2.3
MIN_TORCH = (2, 3, 0)
CAPABILITY = (9, 0)


def parse_version(v: str):
    parts = []
    for p in v.split(".")[:3]:
        digits = ""
        for ch in p:  # leading digits only ("0rc1" -> 0)
            if not ch.isdigit():
                break
            digits += ch
        parts.append(int(digits or 0))
    return tuple(parts)


def check_torch_version(minimum=MIN_TORCH) -> None:
    import torch

    if parse_version(torch.__version__) < tuple(minimum):
        raise ImportError(
            f"ground_plane_polling_tpu_torch requires torch >= "
            f"{'.'.join(map(str, minimum))}, found {torch.__version__}")


def assert_compatible(device="cuda") -> None:
    """Raise unless torch is recent enough and, for a CUDA `device`, torch
    is built with CUDA, sees a card, and the card is compute capability
    9.0 (sm_90a)."""
    import torch

    check_torch_version()
    device = torch.device(device)
    if device.type != "cuda":
        return
    if not torch.version.cuda:
        raise ImportError(f"torch {torch.__version__} is built without "
                          "CUDA; the port's kernels need a CUDA build")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: no card is visible")
    capability = torch.cuda.get_device_capability(device)
    if tuple(capability) != CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} is compute capability "
            f"{capability[0]}.{capability[1]}; the port's kernels are built "
            f"for sm_90a (compute capability "
            f"{CAPABILITY[0]}.{CAPABILITY[1]}, Hopper)")
