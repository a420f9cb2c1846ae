"""Offline tokenizer (``frankenstein_tpu/data/tokenizers.py:ByteTokenizer``)."""

from __future__ import annotations

from typing import List

from frankenstein_tpu_torch.config import GPT2_EOT

EOT_TEXT = "<|endoftext|>"


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
