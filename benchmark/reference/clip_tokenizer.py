"""CLIP BPE tokenizer (pure Python, over a given vocab and merge list).

A copy of the JAX package's conditioning/clip_tokenizer.py. It reproduces
the HF CLIPTokenizer slow-tokenizer semantics (no-ftfy path), including the
`<|image|>`/`<|facial|>` added-token handling, so token indices (which feed
the FuseModule scatter) match the reference exactly.
"""
from __future__ import annotations

import functools
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional

try:  # transformers' dependency, present wherever transformers is
    import regex as _regex

    _PAT = _regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _regex.IGNORECASE)
except ImportError:  # ASCII-equivalent fallback
    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
        re.IGNORECASE)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2/CLIP reversible byte <-> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _basic_clean(text: str) -> str:
    """The HF no-ftfy path: BasicTokenizer(strip_accents=False,
    do_split_on_punc=False) = control-char strip + whitespace split +
    lowercase, rejoined with single spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD:
            continue
        cat = unicodedata.category(ch)
        if cat.startswith("C") and ch not in ("\t", "\n", "\r"):
            continue
        out.append(" " if ch in ("\t", "\n", "\r") or cat == "Zs" else ch)
    return " ".join("".join(out).lower().split())


class CLIPBPETokenizer:
    """HF CLIPTokenizer-compatible interface: encode/add_tokens/
    convert_tokens_to_ids/model_max_length/pad_token_id; `from_pretrained`
    reads a vocab.json/merges.txt dump."""

    def __init__(self, vocab: Dict[str, int], merges: List[str],
                 model_max_length: int = 77, pad_token: Optional[str] = None):
        self.encoder = dict(vocab)
        self.byte_encoder = bytes_to_unicode()
        merge_pairs = [tuple(m.split()) for m in merges]
        self.bpe_ranks = dict(zip(merge_pairs, range(len(merge_pairs))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.model_max_length = model_max_length
        self.bos_token_id = self.encoder["<|startoftext|>"]
        self.eos_token_id = self.encoder["<|endoftext|>"]
        # CLIP-L pads with eos; SDXL's tokenizer_2 (OpenCLIP bigG) pads with
        # "!", id 0, which its dump declares in tokenizer_config.json
        self.pad_token_id = (self.encoder[pad_token] if pad_token is not None
                             else self.eos_token_id)
        self.unk_token_id = self.eos_token_id
        self._added: Dict[str, int] = {}
        self._added_re = None
        # HF registers a declared pad token as special: split verbatim from
        # the text (no </w> word-end form) and mapped to its bare vocab id,
        # so a literal "!" encodes as id 0 through tokenizer_2
        self._special_verbatim: Dict[str, int] = {}
        if pad_token is not None:
            self._special_verbatim[pad_token] = self.encoder[pad_token]
            self._rebuild_added_re()

    @classmethod
    def from_pretrained(cls, path: str, model_max_length: int = 77):
        """path: a diffusers `tokenizer/` dump (vocab.json + merges.txt) or
        a directory containing one (JAX package's
        CLIPBPETokenizer.from_pretrained). A pad_token that the dump's
        tokenizer_config.json or special_tokens_map.json declares is read
        (SDXL's tokenizer_2 pads with "!"); else pads are eos."""
        if os.path.isdir(os.path.join(path, "tokenizer")):
            path = os.path.join(path, "tokenizer")
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            # first line is the "#version" header; HF caps the merge count
            merges = f.read().strip().split("\n")[1: 49152 - 256 - 2 + 1]
        pad_token = None
        for cfg_name in ("tokenizer_config.json", "special_tokens_map.json"):
            cfg_path = os.path.join(path, cfg_name)
            if pad_token is None and os.path.isfile(cfg_path):
                with open(cfg_path, encoding="utf-8") as f:
                    declared = json.load(f).get("pad_token")
                if isinstance(declared, dict):  # AddedToken serialization
                    declared = declared.get("content")
                if declared in vocab:
                    pad_token = declared
        return cls(vocab, merges, model_max_length=model_max_length,
                   pad_token=pad_token)

    # -- added tokens (the <|image|>/<|facial|> triggers) ----------------

    def _rebuild_added_re(self):
        split = {**self._special_verbatim, **self._added}
        longest_first = sorted(split, key=len, reverse=True)
        self._added_re = (re.compile("|".join(map(re.escape, longest_first)))
                          if longest_first else None)

    def add_tokens(self, tokens: List[str]) -> int:
        added = 0
        for t in tokens:
            if t not in self._added and t not in self.encoder:
                self._added[t] = len(self.encoder) + len(self._added)
                added += 1
        self._rebuild_added_re()
        return added

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self._added:
            return self._added[token]
        return self.encoder.get(token, self.unk_token_id)

    # -- BPE core ---------------------------------------------------------

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(
                p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and \
                        word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _tokenize(self, text: str) -> List[str]:
        text = _whitespace_clean(_basic_clean(text))
        bpe_tokens = []
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            bpe_tokens.extend(self.bpe(token).split(" "))
        return bpe_tokens

    # -- public API -------------------------------------------------------

    def tokenize(self, text: str) -> List[str]:
        if self._added_re is None:
            return self._tokenize(text)
        pieces, pos = [], 0
        for m in self._added_re.finditer(text):
            if m.start() > pos:
                pieces.extend(self._tokenize(text[pos:m.start()]))
            pieces.append(m.group(0))
            pos = m.end()
        if pos < len(text):
            pieces.extend(self._tokenize(text[pos:]))
        return pieces

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self.convert_tokens_to_ids(t) for t in self.tokenize(text)]
        if add_special_tokens:
            return [self.bos_token_id] + ids + [self.eos_token_id]
        return ids
