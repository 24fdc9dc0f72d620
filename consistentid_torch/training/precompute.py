"""Synthetic batches for the precomputed-encoder loss (numpy), a copy of
the JAX package's training/precompute.py `synthetic_encoded_batch`: the
`consistentid_loss_encoded` schema at a bundle's shapes, the same draws from
the same seed. Precomputing a corpus is not ported yet."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def synthetic_encoded_batch(bundle, batch_size: int = 2,
                            latent_hw: int = 64, seed: int = 0,
                            max_num_facials: int = 5,
                            mask_hw: Optional[int] = None
                            ) -> Dict[str, np.ndarray]:
    """Random batch with the consistentid_loss_encoded schema at the
    bundle's real shapes."""
    rng = np.random.RandomState(seed)
    v = bundle.vision_config
    t = bundle.text_config
    a = bundle.adapter_config
    n_tok = (v.image_size // v.patch_size) ** 2 + 1
    mask_hw = mask_hw or latent_hw * 8
    lat_c = bundle.vae_config.latent_channels
    f32 = lambda *s: rng.randn(*s).astype(np.float32) * 0.5  # noqa: E731
    idx = np.tile(np.array([[3, 7, 11, 0, 0]], np.int32)
                  [:, :max_num_facials], (batch_size, 1))
    return {
        "latent_mean": f32(batch_size, latent_hw, latent_hw, lat_c),
        "latent_logvar": f32(batch_size, latent_hw, latent_hw, lat_c),
        "face_embeds": f32(batch_size, n_tok, v.hidden_size),
        "region_embeds": f32(batch_size, max_num_facials, n_tok,
                             v.hidden_size),
        "prompt_embeds": f32(batch_size, t.max_position_embeddings,
                             t.hidden_size),
        "faceid_embeds": f32(batch_size, a.id_embeddings_dim),
        "facial_idx": idx,
        "facial_idx_mask": np.tile(
            np.array([[True, True, True, False, False]]
                     [0][:max_num_facials]), (batch_size, 1)),
        "region_masks": (rng.rand(batch_size, max_num_facials, mask_hw,
                                  mask_hw) > 0.5).astype(np.float32),
        "bg_masks": np.ones((batch_size, mask_hw, mask_hw), np.float32),
    }
