"""Word error rate (the competition metric).

The reference loads ``evaluate.load("wer")`` (network-backed,
reference:notebooks/whisper_hugging_face.ipynb cell 11); this is a
self-contained Levenshtein implementation with the same semantics:
WER = (S + D + I) / len(reference_words), corpus-level = total edits / total
reference words.

A copy of ``frankenstein_tpu/eval/wer.py`` (framework-free; the port may not
import the JAX package).
"""

from __future__ import annotations

from typing import List, Sequence


def _edit_distance(ref: List[str], hyp: List[str]) -> int:
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1,        # deletion
                         cur[j - 1] + 1,     # insertion
                         prev[j - 1] + cost) # substitution
        prev = cur
    return prev[m]


def sentence_wer(reference: str, hypothesis: str) -> float:
    ref, hyp = reference.split(), hypothesis.split()
    if not ref:
        return float(bool(hyp))
    return _edit_distance(ref, hyp) / len(ref)


def corpus_wer(references: Sequence[str], hypotheses: Sequence[str]) -> float:
    """Corpus-level WER (matches jiwer / HF evaluate's aggregation)."""
    assert len(references) == len(hypotheses)
    edits, words = 0, 0
    for r, h in zip(references, hypotheses):
        rw, hw = r.split(), h.split()
        edits += _edit_distance(rw, hw)
        words += len(rw)
    return edits / max(words, 1)
