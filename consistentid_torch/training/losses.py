"""Training losses: noise-prediction MSE with the random foreground-mask
branch, and the balanced-L1 facial attention-localization loss.

Counterpart of the JAX package's training/losses.py (reference
functions.py:205-324, train.py:55-89). The attention probabilities are the
UNet's captured attn2 softmax columns (models/unet.py capture_layers), in
the JAX package's order.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the last two dims, as `jax.image.resize(...,
    "bilinear")`: half-pixel centres and, when downsampling, a triangle
    kernel widened by the scale (antialiasing)."""
    lead = x.shape[:-2]
    flat = x.reshape(-1, 1, *x.shape[-2:]).float()
    out = F.interpolate(flat, size=size, mode="bilinear",
                        align_corners=False, antialias=True)
    return out.reshape(*lead, *size)


def balanced_l1_loss(attn_prob: torch.Tensor, segmaps: torch.Tensor,
                     normalize: bool = True) -> torch.Tensor:
    """attn_prob (B, H, Q, N), segmaps (B, 1|H, Q, N) in [0, 1] -> (B, H, N):
    per (batch, head, token) mean prob over background minus over object
    (reference BalancedL1Loss, functions.py:301-324)."""
    if normalize:
        attn_prob = attn_prob / (
            attn_prob.amax(dim=2, keepdim=True) + 1e-5)
    background = 1.0 - segmaps
    bg_sum = background.sum(dim=2) + 1e-5
    obj_sum = segmaps.sum(dim=2) + 1e-5
    bg_loss = (attn_prob * background).sum(dim=2) / bg_sum
    obj_loss = (attn_prob * segmaps).sum(dim=2) / obj_sum
    return bg_loss - obj_loss


def localization_loss_for_layer(attn_prob: torch.Tensor,
                                segmaps: torch.Tensor,
                                token_idx: torch.Tensor,
                                token_idx_mask: torch.Tensor,
                                normalize: bool = True,
                                pregathered: bool = False) -> torch.Tensor:
    """attn_prob (B, H, Q, K_text), or its (B, H, Q, N) facial-token
    columns when `pregathered`; segmaps (B, N, Hm, Wm); token_idx (B, N)
    int; token_idx_mask (B, N) bool (reference functions.py:205-244)."""
    b, h, q, _ = attn_prob.shape
    n = segmaps.shape[1]
    size = int(round(q ** 0.5))
    maps = resize_bilinear(segmaps, (size, size))
    maps = maps.reshape(b, 1, n, q).transpose(2, 3)          # (B, 1, Q, N)
    if pregathered:
        if attn_prob.shape[-1] != n:
            raise ValueError(f"pregathered probs {tuple(attn_prob.shape)} "
                             f"for {n} regions")
        token_prob = attn_prob
    else:
        idx = token_idx.long()[:, None, None, :].expand(b, h, q, n)
        token_prob = attn_prob.gather(3, idx)
    loss = balanced_l1_loss(token_prob, maps, normalize)      # (B, H, N)
    loss = loss * token_idx_mask[:, None, :].to(loss.dtype)
    count = token_idx_mask.sum(dim=1).to(loss.dtype)[:, None] + 1e-5
    return (loss.sum(dim=2) / count).mean()


def localization_loss(attn_probs: Sequence[torch.Tensor],
                      segmaps: torch.Tensor, token_idx: torch.Tensor,
                      token_idx_mask: torch.Tensor, normalize: bool = True,
                      pregathered: bool = False) -> torch.Tensor:
    """Average over the captured layers (reference functions.py:247-261)."""
    total = 0.0
    for p in attn_probs:
        total = total + localization_loss_for_layer(
            p.float(), segmaps, token_idx, token_idx_mask, normalize,
            pregathered=pregathered)
    return total / max(len(attn_probs), 1)


def collect_attn_probs(captured: Dict[str, torch.Tensor]
                       ) -> List[torch.Tensor]:
    """The UNet's captured {module path: probs} as a list in path order, as
    the JAX package sorts its sown tensors."""
    return [captured[k] for k in sorted(captured)]


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 mean-squared error; with mask, both sides are multiplied by it
    first (reference train.py:59-72)."""
    pred = pred.float()
    target = target.float()
    if mask is not None:
        mask = mask.float()
        pred = pred * mask
        target = target * mask
    return torch.mean((pred - target) ** 2)
