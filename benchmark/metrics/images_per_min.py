"""images_per_min: images completed without error, per minute, over the
time from the window's start to the completion of the last request sent
before the window ended (so whole batches count, and a stall counts)."""


def read(ctx):
    ok = [r for r in ctx.records if r.ok]
    if not ok:
        return None
    return len(ok) * 60.0 / (max(r.done for r in ok) - ctx.t0)
