"""mfu.serve (whole step): model FLOPs of the window's completed images
(harness/yardstick.py's count over the reference: UNet calls, text
encodes, ViT-H, VAE decode, perception and safety networks; padded rows
not counted) over the window's seconds times the card's bf16 dense peak,
989 TFLOP/s, in percent."""
from benchmark.harness.yardstick import PEAK_BF16_FLOPS


def read(ctx):
    ok = [r for r in ctx.records if r.ok]
    if not ok:
        return None
    seconds = max(r.done for r in ok) - ctx.t0
    return (sum(ctx.request_flops().values()) * len(ok)
            / (seconds * PEAK_BF16_FLOPS) * 100.0)
