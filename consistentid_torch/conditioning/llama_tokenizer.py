"""The Llama-2 / llava-hf tokenizer from an HF `tokenizer.json`, in plain
Python: the tokenizer `LlavaCaptioner.from_pretrained` uses where the JAX
package calls `transformers.AutoTokenizer` (its conditioning/captioner.py),
since the card's machine has neither `transformers` nor `tokenizers`.

It reads the file's parts of the kind Llama-2 and llava-hf ship and
reproduces the `tokenizers` library on them:
  - added tokens (`<unk>`, `<s>`, `</s>`, llava-hf's `<image>`, `<pad>`),
    split out of the text first, leftmost-longest, with lstrip/rstrip;
  - the normalizer: Prepend "▁" and Replace " " -> "▁" (in a Sequence),
    applied to each piece between added tokens; or a Metaspace
    pre-tokenizer (prepend scheme always / first / never, split or not);
  - the BPE model: the pieces' characters, a character missing from the
    vocab as its UTF-8 bytes `<0xXX>` (`byte_fallback`) or else `<unk>`
    (consecutive ones fused with `fuse_unk`), then the merges applied
    lowest rank first, leftmost first among equal ranks;
  - the post-processor: TemplateProcessing's single-sequence template
    (Llama's "<s> $A"), with `add_special_tokens`;
  - the decoder: a Sequence of Replace, ByteFallback (a run of byte tokens
    as UTF-8, or one U+FFFD per byte when invalid), Fuse, Strip and
    Metaspace.
bos/eos tokens are read from tokenizer_config.json when present, else
"<s>" and "</s>". A directory with only the SentencePiece `tokenizer.model`
is refused: that format is not read here.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

SPIECE_UNDERLINE = "▁"


def _token_content(tok) -> str:
    return tok if isinstance(tok, str) else tok.get("content", "")


class LlamaTokenizer:
    def __init__(self, spec: Dict, bos_token: str = "<s>",
                 eos_token: str = "</s>"):
        model = spec["model"]
        if model.get("type", "BPE") != "BPE":
            raise ValueError(f"tokenizer.json model {model.get('type')!r}: "
                             "only BPE is read here")
        if model.get("dropout"):
            raise ValueError("BPE dropout is not supported")
        if model.get("continuing_subword_prefix") or \
                model.get("end_of_word_suffix"):
            raise ValueError("BPE subword prefixes/suffixes are not "
                             "supported")
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.fuse_unk = bool(model.get("fuse_unk", False))
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.unk_token = model.get("unk_token")
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(model.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.merges[(self.vocab[a], self.vocab[b])] = (
                rank, self.vocab[a + b])
        self.added: List[Dict] = []
        for t in spec.get("added_tokens") or []:
            if t.get("single_word"):
                raise ValueError(f"added token {t['content']!r}: single_word "
                                 "is not supported")
            self.added.append(t)
            self.vocab.setdefault(t["content"], t["id"])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        for t in self.added:
            self.id_to_token[t["id"]] = t["content"]
        self.special_ids = {t["id"] for t in self.added if t.get("special")}
        self.normalizers = self._normalizers(spec.get("normalizer"))
        self.pre_tokenizer = spec.get("pre_tokenizer")
        if self.pre_tokenizer and self.pre_tokenizer["type"] != "Metaspace":
            raise ValueError(f"pre-tokenizer {self.pre_tokenizer['type']!r} "
                             "is not supported")
        self.decoders = self._decoders(spec.get("decoder"))
        self.template = self._template(spec.get("post_processor"))
        self.bos_token, self.eos_token = bos_token, eos_token

    # ------------------------------------------------------------ loading

    @classmethod
    def from_file(cls, path: str, **kw) -> "LlamaTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f), **kw)

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "LlamaTokenizer":
        """The tokenizer.json (and tokenizer_config.json's bos/eos) of an
        HF model directory."""
        path = os.path.join(model_dir, "tokenizer.json")
        if not os.path.isfile(path):
            if os.path.isfile(os.path.join(model_dir, "tokenizer.model")):
                raise ValueError(
                    f"{model_dir} has tokenizer.model (SentencePiece) but no "
                    "tokenizer.json: only the HF tokenizer.json is read here; "
                    "convert it with transformers' LlamaTokenizerFast first")
            raise FileNotFoundError(f"no tokenizer.json in {model_dir}")
        kw = {}
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.isfile(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            for key in ("bos_token", "eos_token"):
                if cfg.get(key):
                    kw[key] = _token_content(cfg[key])
        return cls.from_file(path, **kw)

    @staticmethod
    def _normalizers(spec) -> List[Dict]:
        if spec is None:
            return []
        parts = spec["normalizers"] if spec["type"] == "Sequence" else [spec]
        for n in parts:
            if n["type"] not in ("Prepend", "Replace"):
                raise ValueError(f"normalizer {n['type']!r} is not supported")
        return parts

    @staticmethod
    def _decoders(spec) -> List[Dict]:
        if spec is None:
            return []
        parts = spec["decoders"] if spec["type"] == "Sequence" else [spec]
        for d in parts:
            if d["type"] not in ("Replace", "ByteFallback", "Fuse", "Strip",
                                 "Metaspace"):
                raise ValueError(f"decoder {d['type']!r} is not supported")
        return parts

    @staticmethod
    def _template(spec) -> Optional[List[Tuple[str, str]]]:
        """TemplateProcessing's single template as [("special", token) or
        ("sequence", "A")]; None without a post-processor."""
        if spec is None:
            return None
        if spec["type"] != "TemplateProcessing":
            raise ValueError(f"post-processor {spec['type']!r} is not "
                             "supported")
        out = []
        for piece in spec["single"]:
            if "SpecialToken" in piece:
                out.append(("special", piece["SpecialToken"]["id"]))
            else:
                out.append(("sequence", piece["Sequence"]["id"]))
        special = {k: v["ids"] for k, v in spec.get("special_tokens",
                                                     {}).items()}
        return [(kind, val, special.get(val)) for kind, val in out]

    # ------------------------------------------------------------- ids

    @property
    def bos_token_id(self) -> int:
        return self.vocab[self.bos_token]

    @property
    def eos_token_id(self) -> int:
        return self.vocab[self.eos_token]

    # ----------------------------------------------------------- encode

    def _split_added(self, text: str, normalized: bool
                     ) -> List[Tuple[str, Optional[int]]]:
        """text -> [(piece, None) or (token, id)]: the added tokens whose
        `normalized` flag is `normalized`, leftmost-longest."""
        tokens = [t for t in self.added
                  if bool(t.get("normalized", not t.get("special"))) ==
                  normalized]
        out: List[Tuple[str, Optional[int]]] = []
        pos = start = 0
        while pos < len(text):
            best = None
            for t in tokens:
                c = t["content"]
                if c and text.startswith(c, pos) and \
                        (best is None or len(c) > len(best["content"])):
                    best = t
            if best is None:
                pos += 1
                continue
            s, e = pos, pos + len(best["content"])
            if best.get("lstrip"):
                while s > start and text[s - 1].isspace():
                    s -= 1
            if best.get("rstrip"):
                while e < len(text) and text[e].isspace():
                    e += 1
            if s > start:
                out.append((text[start:s], None))
            out.append((best["content"], best["id"]))
            pos = start = e
        if start < len(text):
            out.append((text[start:], None))
        return out

    def _normalize(self, text: str) -> str:
        for n in self.normalizers:
            if n["type"] == "Prepend":
                if text:
                    text = n["prepend"] + text
            else:
                text = text.replace(n["pattern"]["String"], n["content"])
        return text

    def _pre_tokenize(self, text: str, first: bool) -> List[str]:
        pt = self.pre_tokenizer
        if pt is None:
            return [text] if text else []
        rep = pt.get("replacement", SPIECE_UNDERLINE)
        text = text.replace(" ", rep)
        scheme = pt.get("prepend_scheme",
                        "always" if pt.get("add_prefix_space", True)
                        else "never")
        if text and not text.startswith(rep) and (
                scheme == "always" or (scheme == "first" and first)):
            text = rep + text
        if not pt.get("split", True):
            return [text] if text else []
        words, cur = [], ""
        for ch in text:
            if ch == rep and cur:
                words.append(cur)
                cur = ""
            cur += ch
        if cur:
            words.append(cur)
        return words

    def _symbols(self, word: str) -> List[int]:
        unk_id = self.vocab.get(self.unk_token) if self.unk_token else None
        out: List[int] = []
        pending_unk = False
        for ch in word:
            if ch in self.vocab:
                if pending_unk:
                    out.append(unk_id)
                    pending_unk = False
                out.append(self.vocab[ch])
                continue
            if self.byte_fallback:
                ids = [self.vocab.get(f"<0x{b:02X}>")
                       for b in ch.encode("utf-8")]
                if all(i is not None for i in ids):
                    out.extend(ids)
                    continue
            if unk_id is None:
                raise ValueError(f"character {ch!r} is not in the vocab and "
                                 "the model has no unk token")
            if pending_unk and not self.fuse_unk:
                out.append(unk_id)
            pending_unk = True
        if pending_unk:
            out.append(unk_id)
        return out

    def _bpe(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        syms = self._symbols(word)
        while len(syms) > 1:
            best = None
            for i in range(len(syms) - 1):
                m = self.merges.get((syms[i], syms[i + 1]))
                if m is not None and (best is None or m[0] < best[0]):
                    best = (m[0], i, m[1])
            if best is None:
                break
            _, i, new = best
            syms[i:i + 2] = [new]
        return syms

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        first = True
        for piece, tid in self._split_added(text, normalized=False):
            if tid is not None:
                ids.append(tid)
                first = False
                continue
            for sub, sid in self._split_added(self._normalize(piece),
                                              normalized=True):
                if sid is not None:
                    ids.append(sid)
                    continue
                for word in self._pre_tokenize(sub, first):
                    ids.extend(self._bpe(word))
            first = False
        if add_special_tokens and self.template is not None:
            out: List[int] = []
            for kind, val, special_ids in self.template:
                if kind == "sequence":
                    out.extend(ids)
                else:
                    out.extend(special_ids if special_ids is not None
                               else [self.vocab[val]])
            return out
        return ids

    # ----------------------------------------------------------- decode

    def _decode_chain(self, tokens: List[str]) -> List[str]:
        for d in self.decoders:
            kind = d["type"]
            if kind == "Replace":
                pat, content = d["pattern"]["String"], d["content"]
                tokens = [t.replace(pat, content) for t in tokens]
            elif kind == "Fuse":
                tokens = ["".join(tokens)]
            elif kind == "Strip":
                tokens = [self._strip(t, d["content"], d["start"], d["stop"])
                          for t in tokens]
            elif kind == "Metaspace":
                rep = d.get("replacement", SPIECE_UNDERLINE)
                scheme = d.get("prepend_scheme",
                               "always" if d.get("add_prefix_space", True)
                               else "never")
                out = []
                for i, t in enumerate(tokens):
                    t = t.replace(rep, " ")
                    if i == 0 and scheme != "never" and t.startswith(" "):
                        t = t[1:]
                    out.append(t)
                tokens = out
            else:
                tokens = self._byte_fallback(tokens)
        return tokens

    @staticmethod
    def _strip(token: str, content: str, start: int, stop: int) -> str:
        s, e = 0, len(token)
        for i in range(min(start, len(token))):
            if token[i] != content:
                break
            s = i + 1
        for i in range(min(stop, len(token) - s)):
            if token[e - 1] != content:
                break
            e -= 1
        return token[s:e]

    @staticmethod
    def _byte_fallback(tokens: Sequence[str]) -> List[str]:
        out: List[str] = []
        pending = bytearray()

        def flush():
            if pending:
                try:
                    out.append(pending.decode("utf-8"))
                except UnicodeDecodeError:
                    out.extend("�" for _ in pending)
                pending.clear()

        for t in tokens:
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                try:
                    pending.append(int(t[3:5], 16))
                    continue
                except ValueError:
                    pass
            flush()
            out.append(t)
        flush()
        return out

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = False) -> str:
        tokens = [self.id_to_token[int(i)] for i in ids
                  if int(i) in self.id_to_token and not (
                      skip_special_tokens and int(i) in self.special_ids)]
        if not self.decoders:
            return " ".join(tokens)
        return "".join(self._decode_chain(tokens))
