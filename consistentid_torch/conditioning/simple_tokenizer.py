"""Deterministic offline word-hash tokenizer (a copy of the JAX package's
conditioning/simple_tokenizer.py).

The real pipelines use the CLIP BPE tokenizer (any object with
`encode(text) -> list[int]`, `model_max_length`, `pad_token_id` works).
This stand-in is the checkpoint loader's warned fallback when a dump ships
no tokenizer vocab: stable word-level ids via
hashing, CLIP-compatible special-token layout (bos/eos/pad), and
`add_tokens` for the `<|image|>` / `<|facial|>` triggers the pipelines
register (reference pipline_StableDiffusion_ConsistentID.py:148-150).
"""
from __future__ import annotations

import hashlib
import re
from typing import Dict, List

_TOKEN_RE = re.compile(r"<\|[a-z]+\|>|\b[\w']+\b|[.,;!?]")


class SimpleTokenizer:
    def __init__(self, model_max_length: int = 77, vocab_size: int = 49408):
        self.model_max_length = model_max_length
        self.vocab_size = vocab_size
        self.bos_token_id = vocab_size - 2      # mirrors CLIP: 49406
        self.eos_token_id = vocab_size - 1      # 49407
        self.pad_token_id = self.eos_token_id   # CLIP pads with eos
        self._added: Dict[str, int] = {}

    def add_tokens(self, tokens: List[str]) -> int:
        for t in tokens:
            if t not in self._added:
                self._added[t] = self.vocab_size + len(self._added)
        return len(tokens)

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self._added:
            return self._added[token]
        digest = hashlib.md5(token.lower().encode()).digest()
        # keep clear of the special ids at the top of the range
        return int.from_bytes(digest[:4], "little") % (self.vocab_size - 3) + 1

    def encode(self, text: str) -> List[int]:
        ids = [self.convert_tokens_to_ids(t) for t in _TOKEN_RE.findall(text)]
        ids = ids[: self.model_max_length - 2]
        return [self.bos_token_id] + ids + [self.eos_token_id]
