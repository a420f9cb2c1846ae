"""Text utilities (reference:utils/data_utils.py:202-289 and
notebooks/submit_data.ipynb cell 0).

A copy of ``frankenstein_tpu/data/text.py`` (framework-free; the port may
not import the JAX package).
"""

from __future__ import annotations

import string
from typing import Iterable, List

_PUNCT = string.punctuation.replace("'", "")


def process_string(text: str) -> str:
    """Lowercase + strip punctuation except apostrophes — the eval.ai
    submission normalization (reference:data_utils.py:204-208)."""
    text = text.lower()
    return "".join(ch for ch in text if ch not in _PUNCT)


def remove_punctuation(text: str) -> str:
    return "".join(ch for ch in text if ch not in _PUNCT)


def save_sentences_to_txt(fpath, sentences: Iterable[str], string_processing_fn=None):
    fn = string_processing_fn or (lambda s: s)
    with open(fpath, "w", encoding="utf-8") as f:
        for s in sentences:
            f.write(fn(s) + "\n")


def load_sentences_from_txt(fpath) -> List[str]:
    with open(fpath, "r", encoding="utf-8") as f:
        return [line.strip() for line in f.readlines()]


def pad_token_list(tokens: List[int], max_tokens: int,
                   pad_value: int = -100) -> List[int]:
    """Pad with -100 (ignored by CE) to fixed length
    (reference:data_utils.py:282-286). Truncates if over-long."""
    out = list(tokens[:max_tokens])
    out.extend([pad_value] * (max_tokens - len(out)))
    return out


def remove_padding(tokens: Iterable[int], pad_value: int = -100) -> List[int]:
    return [t for t in tokens if t != pad_value]
