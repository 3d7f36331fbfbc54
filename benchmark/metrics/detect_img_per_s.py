"""detect_img_per_s: frames whose outputs reached host memory over the
window's seconds (first upload to last outputs read back). Host clock."""


def read(ctx):
    return ctx.frames / ctx.window_s if ctx.window_s > 0 else None
