"""Geometry and detection math: anchors, box/dim decode, IoU, filtering,
ground-plane polling (plain twin of the CUDA kernel) and the pose solve."""
