"""ChatML conversation template (copy of the `qwen_2` entry of
blim_tpu/data/conversation.py, the only template BLiM uses).

The other LLM families' templates stay in the JAX package until the port
grows a chat front end.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class Conversation:
    """ChatML prompt template. `get_prompt()` renders

        system + sep + "\\n"
        + for each (role, message):
            role + "\\n" + message + sep + "\\n"   if message
            role + "\\n"                            otherwise
    """

    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]] = dataclasses.field(default_factory=list)
    sep: str = "<|im_end|>"

    def copy(self) -> "Conversation":
        return Conversation(system=self.system, roles=self.roles,
                            messages=[[r, m] for r, m in self.messages], sep=self.sep)

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        ret = "" if self.system == "" else self.system + self.sep + "\n"
        for role, message in self.messages:
            if message:
                ret += role + "\n" + message + self.sep + "\n"
            else:
                ret += role + "\n"
        return ret


conv_qwen = Conversation(
    system="<|im_start|>system\nYou are a helpful assistant.",
    roles=("<|im_start|>user", "<|im_start|>assistant"),
    sep="<|im_end|>",
)

conv_templates = {"qwen_1_5": conv_qwen, "qwen_2": conv_qwen}
