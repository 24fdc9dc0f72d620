"""Trigger-token mask construction (host-side numpy).

A copy of the JAX package's conditioning/tokenize.py (reference
functions.py:111-203). Works with any tokenizer exposing
`encode(text) -> list[int]`, `model_max_length` and `pad_token_id`.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def tokenize_and_mask_trigger_ends(
    text: str,
    image_token_id: int,
    facial_token_id: int,
    tokenizer,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tokenize marked text; mark the token *preceding* each trigger token;
    strip triggers; pad/truncate to model_max_length.

    Returns (clean_input_ids (1, L) int64, image_mask (1, L) bool,
    facial_mask (1, L) bool). Reference quirk preserved: the image-trigger
    branch offsets by the number of image triggers seen so far
    (functions.py:121), the facial branch does not (:124).
    """
    input_ids = list(tokenizer.encode(text))
    image_mask = [False] * len(input_ids)
    facial_mask = [False] * len(input_ids)
    clean_ids: List[int] = []
    image_num = 0

    for tok in input_ids:
        if tok == image_token_id:
            image_mask[len(clean_ids) + image_num - 1] = True
            image_num += 1
        elif tok == facial_token_id:
            facial_mask[len(clean_ids) - 1] = True
        else:
            clean_ids.append(tok)

    max_len = tokenizer.model_max_length

    def fit(seq, pad):
        seq = seq[:max_len]
        return seq + [pad] * (max_len - len(seq))

    clean = np.asarray(fit(clean_ids, tokenizer.pad_token_id),
                       dtype=np.int64)[None]
    img = np.asarray(fit(image_mask, False), dtype=bool)[None]
    fac = np.asarray(fit(facial_mask, False), dtype=bool)[None]
    return clean, img, fac


def prepare_trigger_token_idx(
    image_token_mask: np.ndarray,
    facial_token_mask: np.ndarray,
    max_num_objects: int = 2,
    max_num_facials: int = 5,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Boolean masks (1, L) -> zero-padded index arrays (1, N) + validity
    masks; static shapes for the fuse scatter (reference functions.py:158-203).
    """

    def pack(mask: np.ndarray, n: int):
        idx = np.nonzero(mask)[1]
        valid = np.ones_like(idx, dtype=bool)
        if len(idx) < n:
            idx = np.concatenate([idx, np.zeros(n - len(idx), np.int64)])
            valid = np.concatenate([valid, np.zeros(n - len(valid), bool)])
        return idx[None], valid[None]

    image_idx, image_valid = pack(image_token_mask, max_num_objects)
    facial_idx, facial_valid = pack(facial_token_mask, max_num_facials)
    return image_idx, image_valid, facial_idx, facial_valid
