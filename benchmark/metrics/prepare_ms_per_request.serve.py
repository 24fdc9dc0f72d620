"""prepare_ms_per_request.serve (pipelines): host milliseconds inside the
benchmark's span around the pipeline's prepare_batch (markers, tokens,
masks and the perception hooks), summed over the window, per request sent
in it; rows padded up to a bucket are prepared too, so padding shows."""


def read(ctx):
    if ctx.spans is None or not ctx.records:
        return None
    return ctx.spans.prepare_s * 1e3 / len(ctx.records)
