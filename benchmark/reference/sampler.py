"""The conditioning of one branch of the CFG denoise loop with delayed
("merge-step") conditioning: while i <= start_merge_step the text-only
branch conditions the UNet, the facial-augmented branch afterwards; each
carries its own positive and negative context and, for SDXL, pooled
embeddings, all switched together (reference SDXL :619-628). The loop
itself is followed step by step in stepwise.py."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class CondBranch:
    """One conditioning branch: positive and negative embeddings
    (B, L, D), and for SDXL the pooled positive and negative (B, Dp)."""

    context: torch.Tensor
    null: torch.Tensor
    pooled: Optional[torch.Tensor] = None
    pooled_null: Optional[torch.Tensor] = None
