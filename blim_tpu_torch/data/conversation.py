"""Conversation prompt templates (copy of blim_tpu/data/conversation.py).

BLiM's layouts and the chat use the `qwen_2` ChatML template; the full
template table of the model family renders here with the same strings as
the JAX package: CHATML, MPT, PLAIN, SINGLE (vicuna v0), TWO (vicuna v1),
LLAMA_2, GEMMA. Messages are strings. tests/test_torch_copies.py pins every
template's rendering to the original.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

from blim_tpu_torch.core.constants import DEFAULT_IMAGE_TOKEN  # noqa: F401


class SeparatorStyle(enum.Enum):
    CHATML = enum.auto()
    PLAIN = enum.auto()
    MPT = enum.auto()
    SINGLE = enum.auto()
    TWO = enum.auto()
    LLAMA_2 = enum.auto()
    GEMMA = enum.auto()


@dataclasses.dataclass
class Conversation:
    """ChatML-style conversation prompt template.

    `get_prompt()` renders exactly the string the reference's CHATML branch
    produces (reference: conversation.py:118-127):

        system + sep + "\\n"
        + for each (role, message):
            role + "\\n" + message + sep + "\\n"   if message
            role + "\\n"                            otherwise
    """

    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]] = dataclasses.field(default_factory=list)
    sep_style: SeparatorStyle = SeparatorStyle.CHATML
    sep: str = "<|im_end|>"
    sep2: Optional[str] = None
    version: str = "qwen"

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        if self.sep_style == SeparatorStyle.CHATML:
            ret = "" if self.system == "" else self.system + self.sep + "\n"
            for role, message in self.messages:
                if message:
                    ret += role + "\n" + message + self.sep + "\n"
                else:
                    ret += role + "\n"
            return ret
        if self.sep_style == SeparatorStyle.MPT:
            ret = self.system + self.sep
            for role, message in self.messages:
                if message:
                    ret += role + message + self.sep
                else:
                    ret += role
            return ret
        if self.sep_style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2 or self.sep]
            ret = self.system
            for i, (_, message) in enumerate(self.messages):
                if message:
                    ret += message + seps[i % 2]
            return ret
        if self.sep_style == SeparatorStyle.SINGLE:
            # (reference: conversation.py:69-77)
            ret = self.system + self.sep
            for role, message in self.messages:
                if message:
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.TWO:
            # (reference: conversation.py:79-88)
            seps = [self.sep, self.sep2 or ""]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(self.messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.LLAMA_2:
            # (reference: conversation.py:145-167)
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n" if len(msg) > 0 else msg

            ret = ""
            for i, (role, message) in enumerate(self.messages):
                if i == 0:
                    assert message, "first message should not be none"
                    assert role == self.roles[0], "first message should come from user"
                if message:
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        ret += self.sep + f"[INST] {message} [/INST]"
                    else:
                        ret += " " + message + " " + (self.sep2 or "")
            return ret.lstrip(self.sep)
        if self.sep_style == SeparatorStyle.GEMMA:
            # (reference: conversation.py:133-143)
            ret = ""
            for i, (role, message) in enumerate(self.messages):
                assert role == self.roles[i % 2], (
                    "Conversation should alternate user/assistant/..."
                )
                if message:
                    ret += role + message + self.sep
                else:
                    ret += role
            return ret
        raise ValueError(f"Unsupported separator style: {self.sep_style}")


conv_qwen = Conversation(
    system="<|im_start|>system\nYou are a helpful assistant.",
    roles=("<|im_start|>user", "<|im_start|>assistant"),
    sep_style=SeparatorStyle.CHATML,
    sep="<|im_end|>",
    version="qwen",
)

conv_plain = Conversation(
    system="",
    roles=("", ""),
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
    version="plain",
)

# -- other LLM families' templates (reference: conversation.py:316-563) ------
# Constant tables of the published prompt formats; only `qwen_2` is used by
# BLiM configs, the rest exist for model-family completeness.

_V0_SEED = [
    ["Human", "What are the key differences between renewable and non-renewable energy sources?"],
    [
        "Assistant",
        "Renewable energy sources are those that can be replenished naturally in a relatively "
        "short amount of time, such as solar, wind, hydro, geothermal, and biomass. "
        "Non-renewable energy sources, on the other hand, are finite and will eventually be "
        "depleted, such as coal, oil, and natural gas. Here are some key differences between "
        "renewable and non-renewable energy sources:\n"
        "1. Availability: Renewable energy sources are virtually inexhaustible, while non-renewable "
        "energy sources are finite and will eventually run out.\n"
        "2. Environmental impact: Renewable energy sources have a much lower environmental impact "
        "than non-renewable sources, which can lead to air and water pollution, greenhouse gas emissions, "
        "and other negative effects.\n"
        "3. Cost: Renewable energy sources can be more expensive to initially set up, but they typically "
        "have lower operational costs than non-renewable sources.\n"
        "4. Reliability: Renewable energy sources are often more reliable and can be used in more remote "
        "locations than non-renewable sources.\n"
        "5. Flexibility: Renewable energy sources are often more flexible and can be adapted to different "
        "situations and needs, while non-renewable sources are more rigid and inflexible.\n"
        "6. Sustainability: Renewable energy sources are more sustainable over the long term, while "
        "non-renewable sources are not, and their depletion can lead to economic and social instability.\n",
    ],
]

conv_vicuna_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[list(m) for m in _V0_SEED],
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0",
)

conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the user's questions.",
    roles=("USER", "ASSISTANT"),
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

_LLAMA2_SYS = (
    "You are a helpful, respectful and honest assistant. Always answer as helpfully as "
    "possible, while being safe.  Your answers should not include any harmful, unethical, "
    "racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses "
    "are socially unbiased and positive in nature."
)

conv_llama_2 = Conversation(
    system=_LLAMA2_SYS,
    roles=("USER", "ASSISTANT"),
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

conv_llava_llama_2 = Conversation(
    system="You are a helpful language and vision assistant. You are able to understand the "
           "visual content that the user provides, and assist the user with a variety of tasks "
           "using natural language.",
    roles=("USER", "ASSISTANT"),
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

conv_llava_llama_2_simple = Conversation(
    system="Answer the questions about the visual content that the user provides.",
    roles=("USER", "ASSISTANT"),
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

conv_llava_llama_2_mmtag = Conversation(
    system="Answer the questions about the visual content that the user provides. "
           "The visual content will be provided with the following format: "
           "<Image>visual content</Image>.",
    roles=("USER", "ASSISTANT"),
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2_mmtag",
)

conv_mistral_instruct = Conversation(
    system="",
    roles=("USER", "ASSISTANT"),
    sep_style=SeparatorStyle.LLAMA_2,
    sep="",
    sep2="</s>",
    version="llama_v2",
)

conv_mistral_orca = Conversation(
    system="<|im_start|>system\nYou are MistralOrca, a large language model trained by "
           "Alignment Lab AI. Write out your reasoning step-by-step to be sure you get the "
           "right answers!",
    roles=("<|im_start|>user", "<|im_start|>assistant"),
    sep_style=SeparatorStyle.CHATML,
    sep="<|im_end|>",
    version="mpt",
)

conv_mistral_zephyr = Conversation(
    system="<|system|>\nYou are a helpful AI assistant.",
    roles=("<|user|>\n", "<|assistant|>\n"),
    sep_style=SeparatorStyle.MPT,
    sep="</s>",
    version="mpt",
)

conv_mistral_direct = Conversation(
    system="<|im_start|>system\nAnswer the questions.",
    roles=("<|im_start|>user", "<|im_start|>assistant"),
    sep_style=SeparatorStyle.CHATML,
    sep="<|im_end|>",
    version="mpt",
)

conv_chatml_direct = Conversation(
    system="<|im_start|>system\nAnswer the questions.",
    roles=("<|im_start|>user", "<|im_start|>assistant"),
    sep_style=SeparatorStyle.CHATML,
    sep="<|im_end|>",
    version="mpt",
)

conv_mpt = Conversation(
    system="<|im_start|>system\nA conversation between a user and an LLM-based AI assistant. "
           "The assistant gives helpful and honest answers.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
    version="mpt",
)

conv_llava_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0",
)

conv_llava_v0_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant is able to understand the visual content that the user provides, "
           "and assist the user with a variety of tasks using natural language."
           "The visual content will be provided with the following format: "
           "<Image>visual content</Image>.",
    roles=("Human", "Assistant"),
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0_mmtag",
)

conv_llava_v1 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("USER", "ASSISTANT"),
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_llava_v1_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant is able to understand the visual content that the user provides, "
           "and assist the user with a variety of tasks using natural language."
           "The visual content will be provided with the following format: "
           "<Image>visual content</Image>.",
    roles=("USER", "ASSISTANT"),
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1_mmtag",
)

conv_internlm_2 = Conversation(
    system="<|im_start|>system\nYou are a helpful assistant.",
    roles=("<|im_start|>user", "<|im_start|>assistant"),
    sep_style=SeparatorStyle.CHATML,
    sep="<|im_end|>",
    version="internlm",
)

conv_gemma_instruct = Conversation(
    system="",
    roles=("<start_of_turn>user\n", "<start_of_turn>model\n"),
    sep_style=SeparatorStyle.GEMMA,
    sep="<end_of_turn>\n",
    version="gemma",
)

conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "mistral_instruct": conv_mistral_instruct,
    "mistral_orca": conv_mistral_orca,
    "mistral_zephyr": conv_mistral_zephyr,
    "mistral_direct": conv_mistral_direct,
    "plain": conv_plain,
    "v0_plain": conv_plain,
    "chatml_direct": conv_chatml_direct,
    "llava_v0": conv_llava_v0,
    "llava_v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "llava_v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "llava_llama_2_simple": conv_llava_llama_2_simple,
    "llava_llama_2_mmtag": conv_llava_llama_2_mmtag,
    "llava_mistral_instruct": conv_mistral_instruct,
    "mpt": conv_mpt,
    "qwen_1_5": conv_qwen,
    "qwen_2": conv_qwen,
    "internlm_2": conv_internlm_2,
    "gemma_instruct": conv_gemma_instruct,
}

default_conversation = conv_qwen
