"""The CLIP byte-level BPE tokenizer of the checkpoint's `tokenizer/` folder.

The port's own copy of what the JAX loader takes from
`transformers.CLIPTokenizer` (mvoc_tpu/models/convert.py: load_pipeline),
so that the port depends on neither `transformers` nor its `regex` and
`ftfy`.  It gives the ids `transformers.CLIPTokenizer` gives where ftfy is
absent (as on the H100 machine and the CPU test host):

  1. the checkpoint's special tokens (bos, eos, unk, pad) are split out of
     the text first, leftmost and longest first, and keep their ids;
  2. each other piece goes through HF's BasicTokenizer clean-up: NUL,
     U+FFFD and control characters dropped, whitespace made a space, a
     space around every CJK ideograph, NFC, split on whitespace, lower-cased
     (accents kept, punctuation not split), joined by single spaces;
  3. CLIP's pattern cuts the words: the special tokens, the contractions
     's 't 're 've 'm 'll 'd, runs of letters (Unicode category L*), single
     digits (N*), runs of anything else but whitespace; the first
     alternative that matches at a position wins, as in `regex`;
  4. each word's UTF-8 bytes map to printable characters
     (`bytes_to_unicode`), its last symbol gets "</w>", and the ranked
     merges of merges.txt (its first 48894 lines after the header) join
     symbol pairs, lowest rank first;
  5. [bos] + ids + [eos], truncated to model_max_length (eos kept) and
     padded with the pad token's id to model_max_length.
"""

from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np

_N_MERGES = 49152 - 256 - 2  # the merges CLIP's vocabulary was built from
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
# the defaults of transformers.CLIPTokenizer
_DEFAULTS = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
             "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>"}


@lru_cache
def bytes_to_unicode() -> dict:
    """Byte -> a printable character: bytes that print stand for themselves,
    the rest are shifted past 255, so no byte maps to whitespace."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _category(ch: str) -> str:
    return unicodedata.category(ch)


def basic_clean(text: str) -> str:
    """HF BasicTokenizer(strip_accents=False, do_split_on_punc=False), its
    tokens joined by single spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        cat = _category(ch)
        if cp in (0, 0xFFFD) or (cat.startswith("C") and ch not in "\t\n\r"):
            continue
        if ch in " \t\n\r" or cat == "Zs":
            out.append(" ")
        elif any(lo <= cp <= hi for lo, hi in _CJK):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(w.lower() for w in words)


def split_words(text: str) -> list[str]:
    """re.findall of CLIP's pattern (case-insensitive)
    <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+
    without the `regex` package."""
    out, i, n = [], 0, len(text)
    low = text.lower()
    while i < n:
        ch = text[i]
        special = next((t for t in ("<|startoftext|>", "<|endoftext|>") if low.startswith(t, i)),
                       None)
        if special is None:
            special = next((c for c in _CONTRACTIONS if low.startswith(c, i)), None)
        if special is not None:
            out.append(text[i:i + len(special)])
            i += len(special)
            continue
        cat = _category(ch)
        if cat.startswith("L"):
            j = i + 1
            while j < n and _category(text[j]).startswith("L"):
                j += 1
        elif cat.startswith("N"):
            j = i + 1
        elif ch.isspace():
            i += 1
            continue
        else:
            j = i + 1
            while j < n and not text[j].isspace() and _category(text[j])[0] not in "LN":
                j += 1
        out.append(text[i:j])
        i = j
    return out


def _pairs(word: tuple) -> set:
    return set(zip(word[:-1], word[1:]))


def _token_content(value) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return value


class CLIPTokenizer:
    """Reads `vocab.json`, `merges.txt` and, where present,
    `tokenizer_config.json` (special tokens, model_max_length) and
    `special_tokens_map.json` (special tokens, over the config's).  Called
    as `tokenizer(texts, padding="max_length", max_length=..., truncation=True,
    return_tensors="np")`, it returns {"input_ids": int64 [len(texts),
    max_length]}, the contract of I2VGenXLPipeline.tokenize."""

    def __init__(self, vocab: dict, merges: Sequence[tuple[str, str]],
                 model_max_length: int = 77, special: Optional[dict] = None):
        self.encoder = dict(vocab)
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.model_max_length = int(model_max_length)
        tokens = dict(_DEFAULTS, **(special or {}))
        self.bos_token, self.eos_token = tokens["bos_token"], tokens["eos_token"]
        self.unk_token, self.pad_token = tokens["unk_token"], tokens["pad_token"]
        for name in ("bos_token", "eos_token", "unk_token", "pad_token"):
            if tokens[name] not in self.encoder:
                raise ValueError(f"tokenizer: {name} {tokens[name]!r} is not in the vocabulary")
        # split out of the text before anything else, longest first
        self.special_tokens = sorted(set(tokens[k] for k in _DEFAULTS), key=len, reverse=True)
        self.byte_encoder = bytes_to_unicode()
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @classmethod
    def from_pretrained(cls, directory: str) -> "CLIPTokenizer":
        with open(os.path.join(directory, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(directory, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:_N_MERGES + 1]
        merges = [tuple(line.split()) for line in lines]
        config, special = {}, {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            path = os.path.join(directory, name)
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    raw = json.load(f)
                if name == "tokenizer_config.json":
                    config = raw
                for key in _DEFAULTS:
                    if _token_content(raw.get(key)) is not None:
                        special[key] = _token_content(raw[key])
        return cls(vocab, merges, config.get("model_max_length", 77), special)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _split_special(self, text: str) -> list[str]:
        pieces, start, i = [], 0, 0
        while i < len(text):
            tok = next((t for t in self.special_tokens if text.startswith(t, i)), None)
            if tok is None:
                i += 1
                continue
            pieces += [text[start:i], tok]
            i = start = i + len(tok)
        return pieces + [text[start:]]

    def tokenize(self, text: str) -> list[str]:
        out = []
        for piece in self._split_special(text):
            if piece in self.special_tokens:
                out.append(piece)
                continue
            for word in split_words(basic_clean(piece)):
                mapped = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
                out.extend(self.bpe(mapped).split(" "))
        return out

    def encode(self, text: str, max_length: Optional[int] = None,
               truncation: bool = True) -> list[int]:
        unk = self.encoder[self.unk_token]
        ids = [self.encoder.get(t, unk) for t in self.tokenize(text)]
        if truncation and max_length is not None:
            ids = ids[:max(max_length - 2, 0)]
        return [self.encoder[self.bos_token]] + ids + [self.encoder[self.eos_token]]

    def __call__(self, texts, padding="max_length", max_length: Optional[int] = None,
                 truncation: bool = True, return_tensors: str = "np") -> dict:
        if padding != "max_length" or return_tensors != "np":
            raise ValueError("CLIPTokenizer: only padding='max_length' and "
                             "return_tensors='np' are supported")
        max_length = self.model_max_length if max_length is None else int(max_length)
        rows = [self.encode(t, max_length, truncation) for t in texts]
        if any(len(r) > max_length for r in rows):
            raise ValueError(f"CLIPTokenizer: a text of {max(map(len, rows))} tokens exceeds "
                             f"{max_length} without truncation")
        ids = np.full((len(rows), max_length), self.encoder[self.pad_token], dtype=np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
        return {"input_ids": ids}
