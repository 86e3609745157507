"""Token sequences of BLiM's two scoring directions, built from the chat
template strings and a byte-level tokenizer whose special tokens carry the
Qwen2 ids (a frozen copy of the byte fallback the measured program uses
when a checkpoint has no tokenizer files, so both sides tokenize the same
captions to the same ids).

VTG, P(caption | video):
    <|im_start|>system\\nYou are a helpful assistant.<|im_end|>\\n
    <|im_start|>user\\n[VIDEO]\\n{instruction}<|im_end|>\\n<|im_start|>assistant\\n
    {caption}<|im_end|>\\n
scored on the caption tokens and the two terminator tokens, each predicted
from the position before it. The CPN prior P(caption) is the same sequence
with the video tokens invisible as keys, at unchanged positions.

TVG, P(video | caption):
    <|im_start|>system\\n...<|im_start|>user\\nGenerate a video given the caption.\\n
    Caption: {caption}<|im_end|>\\n<|im_start|>assistant\\n[CLIP x clips]<|im_end|>\\n
left-padded to a fixed length (positions count the padding); the position
before each clip token predicts that clip. The CPN prior P(video) sees only
the instruction turn's first tokens (its length less the trailing
<|im_end|>\\n) of the text, plus the clips and terminators.
"""

from __future__ import annotations

from typing import List, Tuple

SPECIALS = {"<|im_start|>": 151644, "<|im_end|>": 151645, "<|endoftext|>": 151643}
SYSTEM = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
VTG_INSTRUCTIONS = {"MSRVTT": "Describe this video briefly.",
                    "DiDeMo": "Describe this video in detail.",
                    "ActivityNet": "Describe this video in detail.",
                    "LSMDC": "Describe this video in one sentence."}
TVG_INSTRUCTION = "Generate a video given the caption."
TERMINATOR = "<|im_end|>\n"


def tokenize(text: str) -> List[int]:
    """Bytes of the UTF-8 text, special tokens mapped to their Qwen2 ids."""
    ids: List[int] = []
    i = 0
    while i < len(text):
        for s, tid in SPECIALS.items():
            if text.startswith(s, i):
                ids.append(tid)
                i += len(s)
                break
        else:
            ids.extend(text[i].encode("utf-8"))
            i += 1
    return ids


def vtg_parts(caption: str, dataset: str, max_caption_tokens: int
              ) -> Tuple[List[int], List[int], List[int]]:
    """(text before the video, text after it, scored tokens): the scored
    tokens are the caption's (at most max_caption_tokens) and the
    terminators."""
    pre = tokenize(SYSTEM + "<|im_start|>user\n")
    post = tokenize("\n" + VTG_INSTRUCTIONS[dataset] + "<|im_end|>\n<|im_start|>assistant\n")
    scored = tokenize(caption)[:max_caption_tokens] + tokenize(TERMINATOR)
    return pre, post, scored


def tvg_text(caption: str) -> List[int]:
    """The TVG prompt through the assistant header."""
    return tokenize(SYSTEM + "<|im_start|>user\n" + f"{TVG_INSTRUCTION}\nCaption: {caption}"
                    + "<|im_end|>\n<|im_start|>assistant\n")


def tvg_head_length() -> int:
    """Text tokens the TVG prior keeps visible."""
    return len(tokenize(SYSTEM + "<|im_start|>user\n" + TVG_INSTRUCTION + "<|im_end|>\n")) - 2


def tvg_padded_length(max_caption_tokens: int, clips: int, align: int = 64) -> int:
    """Length of the left-padded TVG row: the empty-caption prompt, the
    caption budget, the clips and the terminators, rounded up to `align`."""
    body = len(tvg_text("")) + max_caption_tokens + clips + len(tokenize(TERMINATOR))
    return -(-body // align) * align
