"""Synthetic training batches (numpy), a copy of the JAX package's
training/dataset.py `synthetic_batch`: the same schema and the same draws
from the same seed, so both packages train on identical inputs. The FGID
dataset reader is not ported yet."""
from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_batch(batch_size: int = 2, size: int = 64, clip_size: int = 28,
                    id_dim: int = 512, text_len: int = 77,
                    max_num_facials: int = 5, seed: int = 0,
                    vocab: int = 49408) -> Dict[str, np.ndarray]:
    """Random batch with the exact train_step schema (tests, smoke runs)."""
    rng = np.random.RandomState(seed)
    idx = np.tile(np.array([[3, 7, 11, 0, 0]], np.int32)[:, :max_num_facials],
                  (batch_size, 1))
    mask = np.tile(np.array([[True, True, True, False, False]]
                            [0][:max_num_facials]), (batch_size, 1))
    return {
        "images": rng.randn(batch_size, size, size,
                            3).astype(np.float32) * 0.5,
        "clean_ids": rng.randint(1, vocab - 3,
                                 (batch_size, text_len)).astype(np.int32),
        "face_pixels": rng.randn(batch_size, clip_size, clip_size,
                                 3).astype(np.float32),
        "region_pixels": rng.randn(batch_size, max_num_facials, clip_size,
                                   clip_size, 3).astype(np.float32),
        "faceid_embeds": rng.randn(batch_size, id_dim).astype(np.float32),
        "facial_idx": idx,
        "facial_idx_mask": mask,
        "region_masks": (rng.rand(batch_size, max_num_facials, size,
                                  size) > 0.5).astype(np.float32),
        "bg_masks": (rng.rand(batch_size, size, size) > 0.3
                     ).astype(np.float32),
    }
