"""Device and dtype policy.

Entry points run on the card unless the caller asks for the CPU, and never
drop to the CPU on their own. Parameters and activations share one dtype
(bf16 on the card, fp32 in the CPU tests); softmax, norm statistics and the
sampler's latents stay fp32.
"""
from __future__ import annotations

from typing import Union

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """torch.device for `device`; raises when the card is asked for and
    none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return DTYPES[dtype]
