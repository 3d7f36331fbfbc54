"""Deterministic label colour table (copy of
ground_plane_polling_tpu/utils/colors.py: golden-ratio hue steps, BGR)."""

from __future__ import annotations

import colorsys

__all__ = ["label_color", "COLORS"]


def _make_colors(n=80):
    cols = []
    for i in range(n):
        # golden-ratio hue stepping for well-separated colours
        h = (i * 0.61803398875) % 1.0
        s = 0.9 if i % 2 == 0 else 0.65
        v = 0.95 if i % 3 else 0.75
        r, g, b = colorsys.hsv_to_rgb(h, s, v)
        cols.append((int(b * 255), int(g * 255), int(r * 255)))  # BGR
    return cols


COLORS = _make_colors()


def label_color(label: int):
    """BGR colour for a label id."""
    if 0 <= label < len(COLORS):
        return COLORS[label]
    return (0, 255, 0)
