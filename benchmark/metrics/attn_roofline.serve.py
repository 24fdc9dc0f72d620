"""attn_roofline.serve (ops): the least time the self-attention products
of the traced sub-window's UNet calls need (harness/yardstick.py, counted
from the configuration's shapes at the levels whose token count squared
reaches 1024^2, at the rows every profiled call ran), as a percentage of
the device time of the fused attention kernels (flash_fwd* in the name)
launched inside those calls. Read only where every profiled call ran the
same rows."""
from benchmark.harness.yardstick import serve_attention_least_s


def read(ctx):
    calls = ctx.trace.span_kernels.get("unet") if ctx.trace else None
    rows = ctx.spans.unet_rows_log if ctx.spans else []
    if not calls or not rows or len(set(rows)) != 1:
        return None
    spent = sum(d for ks in calls for n, d in ks if "flash_fwd" in n)
    if spent <= 0:
        return None
    req = ctx.traffic["request"]
    least = len(calls) * serve_attention_least_s(
        ctx.cell.config["unet"], req["height"], req["width"], rows[0])
    return least / spent * 100.0
