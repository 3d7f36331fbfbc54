"""Road-plane database IO: an (N, 4) array of plane coefficients under the
key 'road_planes_database' in a .mat file (copy of
ground_plane_polling_tpu/data/planes.py)."""

from __future__ import annotations

import numpy as np
import scipy.io

__all__ = ["load_plane_database", "save_plane_database"]

_KEY = "road_planes_database"


def load_plane_database(path: str) -> np.ndarray:
    """Load an (N, 4) float array of road-plane coefficients (a, b, c, d)."""
    planes = np.asarray(scipy.io.loadmat(path)[_KEY], dtype=np.float32)
    if planes.ndim != 2 or planes.shape[1] != 4:
        raise ValueError(f"expected (N, 4) plane array, got {planes.shape}")
    return planes


def save_plane_database(path: str, planes: np.ndarray) -> None:
    scipy.io.savemat(path, {_KEY: np.asarray(planes, dtype=np.float64)})
