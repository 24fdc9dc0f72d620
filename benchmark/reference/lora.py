"""LoRA weight folding for inference (counterpart of the JAX package's
models/lora.py): W' = W + scale * up @ down, once per generate, so the
denoise loop runs a LoRA-free UNet."""
from __future__ import annotations

from typing import Dict

import torch

LORA_SUFFIX = "_lora"


def fold_lora_params(state: Dict[str, torch.Tensor],
                     scale: float) -> Dict[str, torch.Tensor]:
    """State dict of a LoRA UNet -> the state dict a lora_rank=0 UNet
    expects: every `X_lora.{down,up}.weight` pair folded into `X.weight`
    (fp32 accumulate, cast back to the weight's dtype) and dropped. Tensors
    that are not folded are passed through, not copied."""
    out = {k: v for k, v in state.items()
           if f"{LORA_SUFFIX}." not in k}
    for key in state:
        if not key.endswith(f"{LORA_SUFFIX}.down.weight"):
            continue
        prefix = key[:-len(f"{LORA_SUFFIX}.down.weight")]
        down = state[key].float()                                 # (r, in)
        up = state[f"{prefix}{LORA_SUFFIX}.up.weight"].float()    # (out, r)
        w = state[f"{prefix}.weight"]                             # (out, in)
        out[f"{prefix}.weight"] = (w.float() + scale * (up @ down)).to(w.dtype)
    return out
