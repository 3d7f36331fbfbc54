"""setup_s: seconds from the start of the process to the first timed
call (weights and inputs made, the detect call built, captured and warmed
up). Host clock."""


def read(ctx):
    return ctx.setup_s
