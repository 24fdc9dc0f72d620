"""device_idle.serve (device): the share of the traced sub-window, in
percent, in which no operation ran on the device (the union of kernel,
copy and set intervals, from the profiler's trace)."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_share * 100.0
