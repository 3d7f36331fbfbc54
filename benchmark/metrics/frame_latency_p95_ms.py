"""frame_latency_p95_ms: 95th percentile, over every frame of the window,
of the host ms from the start of its upload to its outputs in host
memory (linear interpolation between order statistics). Host clock."""

import numpy as np


def read(ctx):
    lat = [c.latency_ms for c in ctx.calls for _ in c.frames]
    return float(np.percentile(lat, 95)) if lat else None
