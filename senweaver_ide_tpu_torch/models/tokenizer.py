"""Tokenizers: HF wrapper when tokenizer files exist locally, byte-level
fallback otherwise (this environment has zero egress, so the fallback is the
default in tests and benches; throughput numbers are tokenizer-independent).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence


class ByteTokenizer:
    """Byte-level tokenizer: ids 0-255 = bytes, then specials."""

    def __init__(self):
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258
        self.vocab_size = 259

    def encode(self, text: str, *, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """Wrapper over a locally-available HuggingFace tokenizer directory."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.bos_id = self._tok.bos_token_id
        self.eos_id = self._tok.eos_token_id
        self.pad_id = self._tok.pad_token_id or self.eos_id
        self.vocab_size = len(self._tok)

    def encode(self, text: str, *, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        if add_eos and self.eos_id is not None:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)


def load_tokenizer(path: Optional[str] = None):
    """HF tokenizer if ``path`` has files, else the byte fallback."""
    if path and os.path.isdir(path):
        try:
            return HFTokenizer(path)
        except Exception:
            pass
    return ByteTokenizer()
