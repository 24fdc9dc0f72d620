"""SDXL ConsistentID training loss (reference train_SDXL.py:36-132), the
counterpart of the JAX package's training/sdxl_loss.py.

Differences from the SD1.5 objective (train_step.consistentid_loss):
  - two text towers: the penultimate hidden states of CLIP-L and bigG
    concatenated to 2048 wide, the pooled embedding bigG's final-layer-normed
    EOS state (as the port's SDXL pipeline takes it: the JAX package skips
    bigG's text_projection, ROADMAP C) (train_SDXL.py:294-300);
  - added_cond = {text_embeds (pooled), time_ids} micro-conditioning from
    the batch (:302-308, utils_SDXL.py:102-122);
  - the ID projection with the SDXL adapter's shortcut;
  - localization_layers 3 (:47), set through TrainConfig.

Use with make_train_step(..., loss_fn=sdxl_consistentid_loss) on an
SDXLBundle. Extra batch fields: clean_ids2 (B, 77), time_ids (B, 6). The
draws are the SD1.5 loss's (`Draws`).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from ..core.config import TrainConfig
from ..sampling import NoiseSchedule
from .train_step import Draws, _adapter_losses


def sdxl_consistentid_loss(bundle, batch: Mapping[str, torch.Tensor],
                           draws: Draws, *, schedule: NoiseSchedule,
                           config: TrainConfig
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b = batch["images"].shape[0]
    with torch.no_grad():       # frozen encoders
        latents = bundle.vae.encode(batch["images"], noise=draws.vae_noise)
        s = bundle.vision_config.image_size
        n_regions = batch["region_pixels"].shape[1]
        vit_in = torch.cat([batch["face_pixels"],
                            batch["region_pixels"].reshape(-1, s, s, 3)])
        _, penult = bundle.image_encoder(vit_in)
        image_embeds = penult[:b]
        region_embeds = penult[b:].reshape(b, n_regions, *penult.shape[1:])
        h1, _ = bundle.text_encoder(batch["clean_ids"],
                                    output_hidden_state_index=-2)
        h2, pooled2 = bundle.text_encoder_2(batch["clean_ids2"],
                                            output_hidden_state_index=-2)
        prompt_embeds = torch.cat([h1, h2], dim=-1)
    added = {"text_embeds": pooled2, "time_ids": batch["time_ids"]}
    return _adapter_losses(bundle, batch, latents, image_embeds,
                           region_embeds, prompt_embeds, draws,
                           schedule=schedule, config=config, added_cond=added)
