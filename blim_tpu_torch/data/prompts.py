"""Prompt construction and the static layouts (copy of
blim_tpu/data/prompts.py). `build_vtg_example`, `build_tvg_example` and
`splice_flat_example` are the reference's flat prompt functions and splice,
byte for byte: the tests and scripts/parity_torch.py hold the layouts and
the reference's own prompt functions to them.

  VTG (score P(text|video)), right-padded:
      [pre][VIDEO x Nv][post][caption ... <|im_end|> \\n][PAD...]
  `pre` (system + user header) and `post` ("\\n" + instruction + turn ends +
  assistant header) are constants per dataset, so the video block and the
  label window live at fixed offsets; only the caption varies.

  TVG (score P(video|text)), left-padded:
      [PAD...][prompt (instruction + caption) + assistant header][CLIP x num_clips][term]
  so the clip block and the gather positions sit at fixed offsets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from blim_tpu_torch.core.constants import DEFAULT_IMAGE_TOKEN, IGNORE_INDEX, IMAGE_TOKEN_INDEX
from blim_tpu_torch.data.conversation import conv_templates

# Dataset-specific VTG instructions.
VTG_INSTRUCTIONS = {
    "DiDeMo": "Describe this video in detail.",
    "ActivityNet": "Describe this video in detail.",
    "LSMDC": "Describe this video in one sentence.",
    "MSRVTT": "Describe this video briefly.",
}
TVG_INSTRUCTION = "Generate a video given the caption."


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX) -> List[int]:
    """Tokenize a prompt containing ``<image>`` placeholders: each chunk is
    tokenized on its own and the chunks are joined with `image_token_index`,
    keeping a BOS token if the tokenizer emits one."""
    chunks = [tokenizer(chunk).input_ids for chunk in prompt.split(DEFAULT_IMAGE_TOKEN)]
    input_ids: List[int] = []
    offset = 0
    bos = getattr(tokenizer, "bos_token_id", None)
    if chunks and chunks[0] and bos is not None and chunks[0][0] == bos:
        offset = 1
        input_ids.append(chunks[0][0])
    for i, chunk in enumerate(chunks):
        if i:
            input_ids.extend([image_token_index] * (offset + 1))
        input_ids.extend(chunk[offset:])
    return input_ids


def get_tvg_prefix_length(tokenizer, init_prompt: str = TVG_INSTRUCTION) -> int:
    """Number of leading TVG-prompt tokens kept visible by the CPN prior mask:
    tokens of the bare instruction turn minus 2 (the trailing
    ``<|im_end|>`` ``\\n``)."""
    conv = conv_templates["qwen_2"].copy()
    conv.append_message(conv.roles[0], init_prompt)
    return len(tokenizer_image_token(conv.get_prompt(), tokenizer)) - 2


def vtg_prompt_strings(caption: str, dataset: str) -> Tuple[str, str]:
    """(prompt-only, full) strings for the VTG direction."""
    instruction = VTG_INSTRUCTIONS[dataset]
    conv = conv_templates["qwen_2"].copy()
    conv.append_message(conv.roles[0], f"{DEFAULT_IMAGE_TOKEN}\n{instruction}")
    conv.append_message(conv.roles[1], None)
    prompt_only = conv.get_prompt()

    conv = conv_templates["qwen_2"].copy()
    conv.append_message(conv.roles[0], f"{DEFAULT_IMAGE_TOKEN}\n{instruction}")
    conv.append_message(conv.roles[1], caption)
    return prompt_only, conv.get_prompt()


def tvg_prompt_strings(caption: str) -> Tuple[str, str]:
    """(prompt-only, full) strings for the TVG direction."""
    conv = conv_templates["qwen_2"].copy()
    conv.append_message(conv.roles[0], f"{TVG_INSTRUCTION}\nCaption: {caption}")
    conv.append_message(conv.roles[1], None)
    prompt_only = conv.get_prompt()

    conv = conv_templates["qwen_2"].copy()
    conv.append_message(conv.roles[0], f"{TVG_INSTRUCTION}\nCaption: {caption}")
    conv.append_message(conv.roles[1], DEFAULT_IMAGE_TOKEN)
    return prompt_only, conv.get_prompt()


def build_vtg_example(caption: str, dataset: str, tokenizer) -> Dict[str, np.ndarray]:
    """Unspliced (flat) VTG ids/labels/mask — exact parity with get_vtg_id.

    Reference: base_dataset.py:60-84. `input_ids` contains one -200 image
    placeholder; `labels` mask everything through the assistant header.
    """
    prompt_only, full = vtg_prompt_strings(caption, dataset)
    prompt_ids = tokenizer_image_token(prompt_only, tokenizer)
    input_ids = tokenizer_image_token(full, tokenizer)
    assert input_ids[: len(prompt_ids)] == prompt_ids, "prompt is not a prefix of the full sequence"
    labels = list(input_ids)
    labels[: len(prompt_ids)] = [IGNORE_INDEX] * len(prompt_ids)
    pad_id = tokenizer.pad_token_id
    attn = [int(t != pad_id) for t in input_ids]
    return {
        "input_ids": np.asarray(input_ids, np.int32),
        "labels": np.asarray(labels, np.int32),
        "attention_mask": np.asarray(attn, np.int32),
        "prompt_len": np.int32(len(prompt_ids)),
    }


def build_tvg_example(caption: str, tokenizer) -> Dict[str, np.ndarray]:
    """Unspliced (flat) TVG ids/labels/mask — exact parity with get_tvg_id.

    Reference: base_dataset.py:86-105.
    """
    prompt_only, full = tvg_prompt_strings(caption)
    prompt_ids = tokenizer_image_token(prompt_only, tokenizer)
    input_ids = tokenizer_image_token(full, tokenizer)
    assert input_ids[: len(prompt_ids)] == prompt_ids, "prompt is not a prefix of the full sequence"
    labels = list(input_ids)
    labels[: len(prompt_ids)] = [IGNORE_INDEX] * len(prompt_ids)
    pad_id = tokenizer.pad_token_id
    attn = [int(t != pad_id) for t in input_ids]
    return {
        "input_ids": np.asarray(input_ids, np.int32),
        "labels": np.asarray(labels, np.int32),
        "attention_mask": np.asarray(attn, np.int32),
        "prompt_len": np.int32(len(prompt_ids)),
    }


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class VTGLayout:
    """Static right-padded VTG layout for one dataset.

    Sequence:  [pre | video x num_video_tokens | post | caption-region | pad]
    where caption-region holds up to `max_caption_tokens` caption ids followed
    by the two terminator tokens (``<|im_end|>``, ``\\n``).
    """

    pre_ids: Tuple[int, ...]
    post_ids: Tuple[int, ...]
    terminator_ids: Tuple[int, ...]
    num_video_tokens: int
    max_caption_tokens: int
    seq_len: int
    pad_id: int

    @property
    def video_start(self) -> int:
        return len(self.pre_ids)

    @property
    def caption_start(self) -> int:
        return len(self.pre_ids) + self.num_video_tokens + len(self.post_ids)

    @property
    def label_window(self) -> Tuple[int, int]:
        """(hidden_start, length): hidden[hidden_start + i] predicts the token
        at caption_start + i, for i in [0, max_caption_tokens + n_term)."""
        return self.caption_start - 1, self.max_caption_tokens + len(self.terminator_ids)

    @property
    def prefix_len(self) -> int:
        """Tokens before the scoring suffix (everything up to, excluding, the
        last post token, whose hidden state predicts the first caption token)."""
        return self.caption_start - 1

    @property
    def suffix_width(self) -> int:
        """Suffix = last post token + caption region."""
        return 1 + self.max_caption_tokens + len(self.terminator_ids)

    def prefix_token_ids(self) -> np.ndarray:
        """(prefix_len,) layout tokens with zeros in the video slot (embeds
        are spliced over them)."""
        ids = np.zeros((self.prefix_len,), np.int32)
        ids[: len(self.pre_ids)] = self.pre_ids
        p = len(self.pre_ids) + self.num_video_tokens
        ids[p:] = self.post_ids[:-1]
        return ids

    def prior_prefix(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, position_ids) of the text-only CPN-prior prefix: pre + post
        tokens at their original (video-gapped) layout positions."""
        ids = np.asarray(list(self.pre_ids) + list(self.post_ids[:-1]), np.int32)
        pos = np.concatenate([
            np.arange(len(self.pre_ids)),
            np.arange(len(self.pre_ids) + self.num_video_tokens, self.caption_start - 1),
        ]).astype(np.int32)
        return ids, pos

    def caption_token_ids(self, caption: str, tokenizer, dataset: str) -> List[int]:
        """Caption tokens extracted in context from the full rendered prompt,
        so BPE merges at the assistant-header boundary match whole-string
        tokenization."""
        if not caption:
            raise ValueError("empty caption cannot be scored")
        prompt_only, full = vtg_prompt_strings(caption, dataset)
        p = tokenizer_image_token(prompt_only, tokenizer)
        f = tokenizer_image_token(full, tokenizer)
        assert f[: len(p)] == p, "prompt is not a token prefix of the full sequence"
        tail = f[len(p):]
        n_term = len(self.terminator_ids)
        assert tuple(tail[len(tail) - n_term:]) == self.terminator_ids
        return tail[: len(tail) - n_term]

    def encode_caption(self, caption: str, tokenizer, dataset: str) -> Dict[str, np.ndarray]:
        return self.encode(self.caption_token_ids(caption, tokenizer, dataset))

    def encode(self, caption_ids: Sequence[int]) -> Dict[str, np.ndarray]:
        """Fixed-shape arrays for one caption (video embeds spliced later)."""
        cap = list(caption_ids)[: self.max_caption_tokens]
        ids = np.full((self.seq_len,), self.pad_id, np.int32)
        labels = np.full((self.seq_len,), IGNORE_INDEX, np.int32)
        attn = np.zeros((self.seq_len,), np.int32)
        is_video = np.zeros((self.seq_len,), np.int32)

        p = len(self.pre_ids)
        ids[:p] = self.pre_ids
        is_video[p : p + self.num_video_tokens] = 1
        ids[p : p + self.num_video_tokens] = 0
        p += self.num_video_tokens
        ids[p : p + len(self.post_ids)] = self.post_ids
        p += len(self.post_ids)
        assert p == self.caption_start
        tail = cap + list(self.terminator_ids)
        ids[p : p + len(tail)] = tail
        labels[p : p + len(tail)] = tail
        real_len = p + len(tail)
        attn[:real_len] = 1
        cpn = attn * (1 - is_video)  # prior P(t): video block masked out
        return {
            "input_ids": ids,
            "labels": labels,
            "attention_mask": attn,
            "cpn_mask": cpn,
            "is_video": is_video,
            "real_len": np.int32(real_len),
        }


@dataclasses.dataclass(frozen=True)
class TVGLayout:
    """Static left-padded TVG layout.

    Sequence:  [pad | prompt(instr+caption)+assistant header | video x num_clips | term]
    Left padding pins the video block to seq positions
    [seq_len - num_clips - n_term, seq_len - n_term).

    The text segment is tokenized in context (the whole prompt string at
    once): a head/caption/tail token split would break under BPE because
    "Caption: " ends with a space that merges into the caption's first word.
    """

    terminator_ids: Tuple[int, ...]    # ("<|im_end|>", "\n")
    tvg_prefix_length: int
    num_clips: int
    seq_len: int
    pad_id: int

    @property
    def video_start(self) -> int:
        return self.seq_len - len(self.terminator_ids) - self.num_clips

    @property
    def gather_positions(self) -> np.ndarray:
        """Hidden-state positions whose outputs predict each clip: one before
        each video token."""
        return np.arange(self.video_start - 1, self.video_start - 1 + self.num_clips)

    @property
    def prefix_len(self) -> int:
        """Left-padded text prompt up to (excluding) the last text token."""
        return self.video_start - 1

    @property
    def suffix_width(self) -> int:
        """[last text token | clip tokens | terminators]."""
        return 1 + self.num_clips + len(self.terminator_ids)

    def encode_caption(self, caption: str, tokenizer) -> Dict[str, np.ndarray]:
        prompt_only, _ = tvg_prompt_strings(caption)
        return self.encode(tokenizer(prompt_only).input_ids)

    def encode(self, text_ids: Sequence[int]) -> Dict[str, np.ndarray]:
        """`text_ids`: the full prompt tokens through the assistant header."""
        n_term = len(self.terminator_ids)
        text = list(text_ids)
        budget = self.seq_len - self.num_clips - n_term
        if len(text) > budget:  # keep the assistant-header tail intact
            # the last 5-6 tokens are "<|im_end|>\n<|im_start|>assistant\n";
            # drop caption tokens immediately before them
            tail_keep = n_term + 3
            overflow = len(text) - budget
            text = text[: len(text) - tail_keep - overflow] + text[len(text) - tail_keep:]
        n_pad = budget - len(text)

        ids = np.full((self.seq_len,), self.pad_id, np.int32)
        labels = np.full((self.seq_len,), IGNORE_INDEX, np.int32)
        attn = np.zeros((self.seq_len,), np.int32)
        cpn = np.zeros((self.seq_len,), np.int32)
        is_video = np.zeros((self.seq_len,), np.int32)

        ids[n_pad: n_pad + len(text)] = text
        attn[n_pad:] = 1
        # CPN prior P(v): only the first tvg_prefix_length prompt tokens stay
        # visible; the caption (and the rest of the text turn) is masked
        cpn[n_pad: n_pad + min(self.tvg_prefix_length, len(text))] = 1
        vs = self.video_start
        is_video[vs: vs + self.num_clips] = 1
        cpn[vs:] = 1  # video block + terminators stay visible in the prior pass
        ids[vs: vs + self.num_clips] = 0
        ids[vs + self.num_clips:] = self.terminator_ids
        labels[vs + self.num_clips:] = self.terminator_ids
        return {
            "input_ids": ids,
            "labels": labels,
            "attention_mask": attn,
            "cpn_mask": cpn,
            "is_video": is_video,
            "real_len": np.int32(len(text) + self.num_clips + n_term),
        }


def _terminator_ids(tokenizer) -> List[int]:
    """Token ids of the assistant-turn terminator ``<|im_end|>\\n``.
    `<|im_end|>` is a special token, so the "\\n" after it tokenizes exactly
    as it does in the full rendered prompt."""
    return tokenizer("<|im_end|>\n").input_ids


def make_vtg_layout(tokenizer, dataset: str, num_video_tokens: int,
                    max_caption_tokens: int = 96, align: int = 64) -> VTGLayout:
    """Derive the static VTG layout for a dataset from its prompt template."""
    prompt_only, _ = vtg_prompt_strings("", dataset)
    prompt_ids = tokenizer_image_token(prompt_only, tokenizer)
    img_pos = prompt_ids.index(IMAGE_TOKEN_INDEX)
    pre = tuple(prompt_ids[:img_pos])
    post = tuple(prompt_ids[img_pos + 1:])
    term = tuple(_terminator_ids(tokenizer))
    body = len(pre) + num_video_tokens + len(post) + max_caption_tokens + len(term)
    return VTGLayout(
        pre_ids=pre,
        post_ids=post,
        terminator_ids=term,
        num_video_tokens=num_video_tokens,
        max_caption_tokens=max_caption_tokens,
        seq_len=_round_up(body, align),
        pad_id=tokenizer.pad_token_id,
    )


def make_tvg_layout(tokenizer, num_clips: int, max_caption_tokens: int = 96,
                    align: int = 64) -> TVGLayout:
    """Derive the static TVG layout from the TVG prompt template."""
    base_ids = tokenizer(tvg_prompt_strings("")[0]).input_ids
    term = tuple(_terminator_ids(tokenizer))
    body = len(base_ids) + max_caption_tokens + num_clips + len(term)
    return TVGLayout(
        terminator_ids=term,
        tvg_prefix_length=get_tvg_prefix_length(tokenizer),
        num_clips=num_clips,
        seq_len=_round_up(body, align),
        pad_id=tokenizer.pad_token_id,
    )


def splice_flat_example(
    example: Dict[str, np.ndarray],
    num_video_tokens: int,
    tvg: bool,
    tvg_prefix_length: int,
) -> Dict[str, np.ndarray]:
    """Reference-shaped splice of a flat (-200 placeholder) example.

    Mirrors prepare_inputs_labels_for_multimodal's label/mask construction
    (reference: modeling_videochat_flash.py:395-444) on token arrays — used by
    tests to check the static layouts against the reference algorithm.
    """
    ids = example["input_ids"]
    labels = example["labels"]
    (img_positions,) = np.nonzero(ids == IMAGE_TOKEN_INDEX)
    assert len(img_positions) == 1
    ip = int(img_positions[0])
    new_ids = np.concatenate([ids[:ip], np.zeros(num_video_tokens, np.int32), ids[ip + 1 :]])
    new_labels = np.concatenate(
        [labels[:ip], np.full(num_video_tokens, IGNORE_INDEX, np.int32), labels[ip + 1 :]]
    )
    is_video = np.zeros(len(new_ids), np.int32)
    is_video[ip : ip + num_video_tokens] = 1
    if tvg:
        cpn = np.ones(len(new_ids), np.int32)
        first_seg = np.zeros(ip, np.int32)
        first_seg[:tvg_prefix_length] = 1
        cpn[:ip] = first_seg
    else:
        cpn = 1 - is_video
    return {
        "input_ids": new_ids,
        "labels": new_labels,
        "cpn_mask": cpn,
        "is_video": is_video,
    }
