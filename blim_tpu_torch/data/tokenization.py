"""Tokenizer loading and a deterministic fallback (copy of
blim_tpu/data/tokenization.py).

The real model uses the Qwen2 BPE tokenizer of the HF checkpoint, loaded
through `transformers` when the checkpoint directory has tokenizer files.
Without them (synthetic runs, tests) `ByteFallbackTokenizer` is a
deterministic byte-level stand-in whose special tokens map to the real
Qwen2 ids, so every layout and score path sees realistic id ranges."""

from __future__ import annotations

import os
from typing import List, Optional

from blim_tpu_torch.core.constants import QWEN2_PAD_TOKEN_ID


class ByteFallbackTokenizer:
    """Byte-level tokenizer with Qwen2-compatible special tokens."""

    SPECIALS = {
        "<|im_start|>": 151644,
        "<|im_end|>": 151645,
        "<|endoftext|>": 151643,
    }

    bos_token_id = None
    eos_token_id = 151645
    pad_token_id = QWEN2_PAD_TOKEN_ID
    name_or_path = "byte-fallback-qwen2"

    class _Enc:
        __slots__ = ("input_ids",)

        def __init__(self, ids: List[int]):
            self.input_ids = ids

    def __call__(self, text: str):
        ids: List[int] = []
        i = 0
        while i < len(text):
            for s, tid in self.SPECIALS.items():
                if text.startswith(s, i):
                    ids.append(tid)
                    i += len(s)
                    break
            else:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return self._Enc(ids)

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        inv = {v: k for k, v in self.SPECIALS.items()}
        out: List[str] = []
        buf = bytearray()
        for t in ids:
            t = int(t)
            if t in inv:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if not skip_special_tokens:
                    out.append(inv[t])
            elif 0 <= t < 256:
                buf.append(t)
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)

    def batch_decode(self, batch, skip_special_tokens: bool = False) -> List[str]:
        return [self.decode(ids, skip_special_tokens=skip_special_tokens) for ids in batch]


def load_tokenizer(model_path: Optional[str] = None):
    """HF tokenizer from a checkpoint directory that has tokenizer files,
    else the byte fallback. `transformers` is imported only in the first
    case, and its absence then raises. Sets pad_token_id = 151643 for Qwen
    when the tokenizer has none."""
    if model_path and os.path.isdir(model_path) and any(
        os.path.exists(os.path.join(model_path, f))
        for f in ("tokenizer.json", "vocab.json", "tokenizer.model")
    ):
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(model_path, trust_remote_code=True)
        if tok.pad_token_id is None and "qwen" in str(tok.name_or_path).lower():
            tok.pad_token_id = QWEN2_PAD_TOKEN_ID
        return tok
    return ByteFallbackTokenizer()
