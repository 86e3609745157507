"""Token-level constants (copy of blim_tpu/core/constants.py)."""

# Label value ignored by the cross-entropy criteria.
IGNORE_INDEX = -100

# Placeholder id spliced into tokenized prompts where video/image embeddings go.
IMAGE_TOKEN_INDEX = -200

# The literal placeholder string used in prompt templates.
DEFAULT_IMAGE_TOKEN = "<image>"

# Qwen2 `<|im_end|>` token id (the ChatML turn terminator).
IMAGE_TOKEN_ID = 151645

# Qwen2 `<|im_start|>` token id.
IM_START_TOKEN_ID = 151644

# Qwen2 `<|endoftext|>` token id, used as pad.
QWEN2_PAD_TOKEN_ID = 151643

# The LLaVA family's image patch and image start / end strings (unused by the
# VideoChat-Flash prompts, kept with the original's constants).
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
