"""setup_s: seconds from the process's start to the first timed request:
imports, kernel load (or build, on a checkout's first run), weights from
the seed, the warm-up of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
