"""unet_device_ms.serve (models): device milliseconds of the kernels
launched inside one UNet call (the benchmark's forward hooks open a span
around each call), the mean over the calls of the traced sub-window."""


def read(ctx):
    calls = ctx.trace.spans_device_s.get("unet") if ctx.trace else None
    if not calls:
        return None
    return sum(calls) / len(calls) * 1e3
