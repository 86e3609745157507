"""Deterministic byte-level tokenizer with Qwen2 special-token ids (copy of
`ByteFallbackTokenizer`, blim_tpu/data/tokenization.py). Synthetic runs and
tests use it, so every layout and score path sees realistic id ranges."""

from __future__ import annotations

from typing import List

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
