"""Ground-Plane-Polling on PyTorch and CUDA: the port of the JAX package
`ground_plane_polling_tpu` to one NVIDIA H100.

The JAX package stays the reference; each module here mirrors the module of
the same name there and is held against it by the tests. This package imports
torch and never JAX.

Subpackages
  ops/      anchors, box/dim decode, IoU, filtering + NMS, polling twin, pose
  models/   ResNet backbone, FPN, heads and the detector (NCHW nn.Modules),
            and the weight bridge from the JAX package's .npz export
  kernels/  hand-written CUDA kernels and their wrappers (csrc/ holds sources)
  data/     KITTI calibration, images, the plane database, host frame prep
  utils/    KITTI txt writer
  bin/      run_network CLI
"""

__version__ = "0.1.0"
