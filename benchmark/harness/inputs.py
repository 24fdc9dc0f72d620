"""Requests and the tokenizer vocabulary, made from the seed.

A request is (prompt, face, seed): the prompt from the traffic mix's fixed
list, the face a 512x512 uint8 image from a pool drawn from the run's seed
(each request names its face by its own seed), and the request's own seed,
which sets its initial latents. The same run seed gives the same requests
in the same order.

The vocabulary is a byte-level CLIP vocabulary with no merges (every byte
and its word-end form, then the start and end tokens; no tokenizer files
exist here, so ids do not match the published vocabulary); SDXL's places
the end token at CLIP's id 49407, where the text towers read the pooled
state.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..reference.clip_tokenizer import bytes_to_unicode

SEED_MASK = (1 << 63) - 1


def mix(*parts: int) -> int:
    """A 63-bit seed from integers (any size, any sign): SplitMix64 over
    their sum chain, so (run seed, client, index) give unrelated seeds."""
    x = 0x9E3779B97F4A7C15
    for p in parts:
        x = (x + (int(p) & ((1 << 64) - 1)) + 0x9E3779B97F4A7C15) \
            & ((1 << 64) - 1)
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
        x = z ^ (z >> 31)
    return x & SEED_MASK


def clip_vocab(sdxl: bool) -> Dict[str, int]:
    syms = list(bytes_to_unicode().values())
    tokens = (syms + [s + "</w>" for s in syms]
              + ["<|startoftext|>", "<|endoftext|>"])
    vocab = {t: i for i, t in enumerate(dict.fromkeys(tokens))}
    if sdxl:
        vocab["<|endoftext|>"] = 49407
    return vocab


def tokenizer_args(sdxl: bool) -> List[Tuple[Dict[str, int], list, dict]]:
    """(vocab, merges, keyword arguments) of each tokenizer: SD1.5 one;
    SDXL two, the second padding with "!" as its published dump does."""
    vocab = clip_vocab(sdxl)
    if not sdxl:
        return [(vocab, [], {})]
    return [(vocab, [], {}), (vocab, [], {"pad_token": "!"})]


def face_pool(seed: int, n: int, size: int) -> np.ndarray:
    """(n, size, size, 3) uint8: smooth colour fields with noise, each face
    its own draw."""
    rng = np.random.default_rng(mix(seed, 0xFACE))
    low = rng.integers(0, 256, (n, size // 32, size // 32, 3)).astype(
        np.float32)
    up = low.repeat(32, axis=1).repeat(32, axis=2)
    noise = rng.normal(0.0, 24.0, (n, size, size, 3)).astype(np.float32)
    return np.clip(up + noise, 0, 255).astype(np.uint8)


class Requests:
    """Deterministic request streams: request (stream, index) -> (prompt,
    face index, seed)."""

    def __init__(self, seed: int, prompts: List[str], faces: np.ndarray):
        self.seed = seed
        self.prompts = prompts
        self.faces = faces

    def get(self, stream: int, index: int):
        s = mix(self.seed, stream, index)
        prompt = self.prompts[s % len(self.prompts)]
        face = (s >> 8) % len(self.faces)
        return prompt, int(face), int(s >> 1) & 0x7FFFFFFF
