"""Offline tokenizers (``frankenstein_tpu/data/tokenizers.py``, copied: the
port may not import the JAX package).

1. ``GPT2BPE``: a self-contained GPT-2 byte-level BPE that loads local
   ``vocab.json``/``merges.txt`` files; exact GPT-2 ids when they exist.
2. Any object with ``bos_token``/``eos_token``/``__call__`` (an HF tokenizer)
   through ``get_tokenizer``.
3. ``ByteTokenizer``: a dependency-free byte-level fallback whose ids stay
   inside the GPT-2 vocab range; used by tests and synthetic data.
"""

from __future__ import annotations

import functools
import json
import os
from pathlib import Path
from typing import Callable, List, Optional

from frankenstein_tpu_torch.config import GPT2_EOT

EOT_TEXT = "<|endoftext|>"


@functools.lru_cache()
def _bytes_to_unicode():
    """GPT-2's reversible byte<->unicode table (public domain algorithm)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class GPT2BPE:
    """Byte-level BPE with GPT-2 merge rules, loaded from local files."""

    def __init__(self, vocab_path: str, merges_path: str):
        with open(vocab_path, encoding="utf-8") as f:
            self.encoder = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_path, encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges
                  if m and not m.startswith("#version")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cache: dict = {}
        import re
        self.pat = re.compile(
            r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+""",
            re.UNICODE)
        self.bos_token = EOT_TEXT
        self.eos_token = EOT_TEXT
        self.eot_id = self.encoder.get(EOT_TEXT, GPT2_EOT)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        if not pairs:
            return token
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
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

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        # split out explicit <|endoftext|> markers
        segments = text.split(EOT_TEXT)
        for si, seg in enumerate(segments):
            if si > 0:
                ids.append(self.eot_id)
            for token in self.pat.findall(seg):
                token = "".join(self.byte_encoder[b]
                                for b in token.encode("utf-8"))
                ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i == self.eot_id:
                continue
            toks.append(self.decoder.get(i, ""))
        text = "".join(toks)
        return bytearray(self.byte_decoder.get(c, ord(" "))
                         for c in text).decode("utf-8", errors="replace")

    def __call__(self, text: str):
        return type("Enc", (), {"input_ids": self.encode(text)})()


class ByteTokenizer:
    """UTF-8 byte fallback; ids < 256 (within the GPT-2 range), eot = 50256.

    Not GPT-2-compatible text-wise — used for synthetic data and tests where
    no BPE assets exist.
    """

    def __init__(self, eot_id: int = GPT2_EOT):
        self.bos_token = EOT_TEXT
        self.eos_token = EOT_TEXT
        self.eot_id = eot_id

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for si, seg in enumerate(text.split(EOT_TEXT)):
            if si > 0:
                ids.append(self.eot_id)
            ids.extend(seg.encode("utf-8"))
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        out = bytearray()
        for i in ids:
            i = int(i)
            if i == self.eot_id:
                if skip_special_tokens:
                    continue
                return out.decode("utf-8", errors="replace")
            if 0 <= i < 256:
                out.append(i)
        return out.decode("utf-8", errors="replace")

    def __call__(self, text: str):
        return type("Enc", (), {"input_ids": self.encode(text)})()


def find_gpt2_assets() -> Optional[tuple]:
    """Look for local vocab.json/merges.txt (env var or common cache spots)."""
    root = os.environ.get("GPT2_BPE_DIR")
    candidates = [root] if root else []
    candidates += [os.path.expanduser("~/.cache/gpt2"), "./gpt2_assets"]
    for c in candidates:
        if not c:
            continue
        v, m = Path(c) / "vocab.json", Path(c) / "merges.txt"
        if v.exists() and m.exists():
            return str(v), str(m)
    return None


def best_available_tokenizer():
    """GPT2BPE when assets exist locally, else the byte fallback."""
    assets = find_gpt2_assets()
    if assets:
        return GPT2BPE(*assets)
    return ByteTokenizer()


def get_tokenizer(tokenizer) -> Callable[[str], List[int]]:
    """bos + text + eos framing (reference:utils/data_utils.py:270-280)."""
    bos = tokenizer.bos_token
    eos = tokenizer.eos_token

    def tokenize_txt(text: str) -> List[int]:
        framed = bos + text + eos
        res = tokenizer(framed)
        return list(res.input_ids if hasattr(res, "input_ids") else res["input_ids"])

    return tokenize_txt
