"""The arithmetic the per-layer metrics are measured against: the card's
published peaks, the least time of an attention product, the self-attention
shapes of a UNet call, and the model FLOPs of one request counted over the
plain reference on the meta device."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def attention_bound_s(b: int, h: int, sq: int, sk: int, d: int,
                      itemsize: int, kind: str = "k1") -> float:
    """Least seconds for one attention product on the card: the larger of
    its FLOPs over the tensor-core peak and its bytes over HBM bandwidth,
    each input read once and each output written once. FLOPs 4, 6, 8 or 10
    x b*h*sq*sk*d (k1: S and PV; fwd also writes the fp32 lse; bwd, dQ, dK
    and dV fused: S, dP, dV, dK, dQ)."""
    bh = b * h
    qo = bh * sq * d * itemsize
    kv = bh * sk * d * itemsize
    stat = bh * sq * 4
    nbytes, mult = {
        "k1": (2 * qo + 2 * kv, 4),
        "fwd": (2 * qo + 2 * kv + stat, 4),
        "bwd": (3 * qo + 4 * kv + 2 * stat, 10),
    }[kind]
    return max(nbytes / PEAK_HBM_BYTES_PER_S,
               mult * bh * sq * sk * d / PEAK_BF16_FLOPS)


def self_attention_shapes(unet: Dict, height: int, width: int,
                          min_elems: int = 1024 * 1024
                          ) -> List[Tuple[int, int, int, int]]:
    """[(calls, heads, tokens, head_dim)] of the self-attention products
    of one UNet call per latent row, at the levels whose token count
    squared is at least `min_elems` (the products the serving path hands
    to a fused attention kernel). Counted from the configuration: each
    transformer layer of a down block, of an up block (one more block per
    level) and of the mid block has one self-attention."""
    boc = unet["block_out_channels"]
    heads = unet["num_attention_heads"]
    n = len(boc)
    lpb = unet["layers_per_block"]
    out = []
    for level in range(n):
        tokens = (height // 8 >> level) * (width // 8 >> level)
        calls = 0
        if unet["down_block_has_attn"][level]:
            calls += (2 * lpb + 1) * unet["transformer_layers_per_block"][level]
        if level == n - 1:
            calls += unet["mid_transformer_depth"]
        if calls and tokens * tokens >= min_elems:
            out.append((calls, heads[level], tokens, boc[level] // heads[level]))
    return out


def serve_attention_least_s(unet: Dict, height: int, width: int,
                            rows: int, itemsize: int = 2) -> float:
    """Least seconds of the K1-sized self-attention of `rows` latent rows
    through one UNet call each."""
    return sum(calls * attention_bound_s(rows, h, s, s, d, itemsize)
               for calls, h, s, d in self_attention_shapes(unet, height,
                                                           width))


def _count(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def request_flops(config: Dict, request: Dict) -> Dict[str, int]:
    """Model FLOPs of one request from the photo, by part, counted over
    the reference's modules on the meta device (attention as matmuls):
    the UNet with its LoRA folded (as served: lora_rank 0) at 2 rows (CFG)
    for every step, the text encodes (three prompts per tower), the ViT-H
    over the face and 5 regions, the VAE decode, SCRFD, iresnet50, BiSeNet
    and the safety checker. Rows padded up to a bucket are not counted."""
    from ..reference import config as rcfg
    from ..reference.arcface import IResNet
    from ..reference.bisenet import BiSeNet
    from ..reference.pipeline import Models
    from ..reference.safety_checker import SafetyChecker
    from ..reference.scrfd import SCRFD, SCRFD_VARIANTS
    from .build import config_kwargs

    h, w, steps = request["height"], request["width"], request["steps"]
    p = config["perception"]
    meta = torch.device("meta")
    config = dict(config, unet=dict(config["unet"], lora_rank=0))
    with meta:
        m = Models(**config_kwargs(config, rcfg)).eval()
    ucfg = m.unet.config
    ctx_len = 77 + ucfg.ip_num_tokens
    out = {}
    with torch.no_grad(), meta:
        x = torch.zeros(2, h // 8, w // 8, ucfg.sample_channels)
        t = torch.zeros(2)
        ctx = torch.zeros(2, ctx_len, ucfg.cross_attention_dim)
        added = None
        if ucfg.is_sdxl:
            added = {"text_embeds": torch.zeros(2, m.text_encoder_2.config
                                                .hidden_size),
                     "time_ids": torch.zeros(2, 6)}
        out["unet"] = steps * _count(lambda: m.unet(x, t, ctx,
                                                    added_cond=added))
        ids = torch.zeros(1, 77, dtype=torch.long)
        towers = [m.text_encoder] + ([m.text_encoder_2] if m.sdxl else [])
        out["text"] = 3 * sum(_count(lambda e=e: e(ids)) for e in towers)
        vs = m.vision_config.image_size
        out["vit"] = _count(lambda: m.image_encoder(
            torch.zeros(6, vs, vs, 3)))
        out["vae_decode"] = _count(lambda: m.vae.decode(
            torch.zeros(1, h // 8, w // 8, 4)))
        det = SCRFD(SCRFD_VARIANTS[p["detector"]]).eval()
        size = p["detector_input"]
        out["scrfd"] = _count(lambda: det(torch.zeros(1, size, size, 3)))
        emb = IResNet().eval()
        out["arcface"] = _count(lambda: emb(torch.zeros(1, 112, 112, 3)))
        par = BiSeNet(p["parser_classes"]).eval()
        ps = p["parser_size"]
        out["bisenet"] = _count(lambda: par.forward_nchw(
            torch.zeros(1, 3, ps, ps)))
        if p.get("safety_checker"):
            chk = SafetyChecker().eval()
            out["safety"] = _count(lambda: chk(torch.zeros(1, 224, 224, 3)))
    return out
