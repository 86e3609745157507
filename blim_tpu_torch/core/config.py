"""Model configuration dataclasses (copy of blim_tpu/core/config.py).

Defaults are the VideoChat-Flash-Qwen2-7B values. `from_hf_config_dict`
ingests a VideoChat-Flash checkpoint's `config.json`, so a checkpoint
directory carries its own configuration.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    """Decoder-only LLM config (Qwen2 family)."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = False
    # Sliding-window attention: dormant in every BLiM config.
    use_sliding_window: bool = False
    sliding_window: Optional[int] = 4096
    max_window_layers: int = 28

    @property
    def num_query_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """UMT ViT-L vision tower config. res448 => 28x28 = 784 patches a frame,
    dim 1024, 24 layers (run to `depth`, the truncation by return_idx), 16
    heads of 64. The extraction path (models/umt_vit.py,
    pipelines/extract.py) runs the tower; the rerank and train paths read
    its cached features."""

    image_size: int = 448
    patch_size: int = 16
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    mlp_ratio: float = 4.0
    num_frames: int = 4
    tubelet_size: int = 1
    return_idx: int = -2
    ckpt_num_frame: int = 4
    layer_norm_eps: float = 1e-6
    final_layer_norm_eps: float = 1e-12
    qkv_bias: bool = True
    init_values: float = 0.0

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def patches_per_frame(self) -> int:
        return self.patches_per_side ** 2

    @property
    def depth(self) -> int:
        """Actual number of transformer blocks run (truncated depth)."""
        return self.num_hidden_layers + self.return_idx + 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full VideoChat-Flash multimodal model config."""

    llm: Qwen2Config = dataclasses.field(default_factory=Qwen2Config)
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)

    mm_hidden_size: int = 1024
    mm_local_num_frames: int = 4
    num_clips: int = 4
    tokens_per_frame: int = 16
    tokenizer_model_max_length: Optional[int] = None
    tokenizer_padding_side: str = "left"
    mm_projector_type: str = "tome16_mlp_hd64"
    vision_encode_type: str = "video_image"
    mm_patch_merge_type: str = "spatial_nopad"
    mm_newline_position: str = "nothing"
    mm_llm_compress: bool = False
    llm_compress_type: str = "attention"
    llm_compress_layer_list: Tuple[int, ...] = ()
    llm_image_token_ratio_list: Tuple[float, ...] = (1.0,)

    @property
    def tokens_per_clip(self) -> int:
        return self.tokens_per_frame * self.mm_local_num_frames

    @property
    def video_tokens_vtg(self) -> int:
        """Spliced video block length in VTG mode (all clip tokens, flattened)."""
        return self.num_clips * self.tokens_per_clip

    @property
    def video_tokens_tvg(self) -> int:
        """Spliced video block length in TVG mode (1 mean-pooled token per clip)."""
        return self.num_clips


def tiny_model_config(
    vocab_size: int = 512,
    hidden_size: int = 64,
    num_hidden_layers: int = 2,
    num_attention_heads: int = 4,
    num_key_value_heads: int = 2,
    intermediate_size: int = 128,
    mm_hidden_size: int = 32,
    num_clips: int = 4,
    image_size: int = 64,
) -> ModelConfig:
    """A tiny config for tests: 2-layer LLM, 2-block ViT."""
    llm = Qwen2Config(
        vocab_size=vocab_size,
        hidden_size=hidden_size,
        intermediate_size=intermediate_size,
        num_hidden_layers=num_hidden_layers,
        num_attention_heads=num_attention_heads,
        num_key_value_heads=num_key_value_heads,
        head_dim=hidden_size // num_attention_heads,
        max_position_embeddings=2048,
    )
    vision = VisionConfig(
        image_size=image_size,
        hidden_size=mm_hidden_size,
        num_hidden_layers=2,
        num_attention_heads=4,
        return_idx=-1,
    )
    return ModelConfig(llm=llm, vision=vision, mm_hidden_size=mm_hidden_size, num_clips=num_clips)


def from_hf_config_dict(d: Dict[str, Any]) -> ModelConfig:
    """Build a ModelConfig from a HuggingFace VideoChat-Flash config.json dict."""
    llm = Qwen2Config(
        vocab_size=d.get("vocab_size", 152064),
        hidden_size=d.get("hidden_size", 3584),
        intermediate_size=d.get("intermediate_size", 18944),
        num_hidden_layers=d.get("num_hidden_layers", 28),
        num_attention_heads=d.get("num_attention_heads", 28),
        num_key_value_heads=d.get("num_key_value_heads", 4),
        head_dim=d.get("head_dim", d.get("hidden_size", 3584) // d.get("num_attention_heads", 28)),
        rope_theta=d.get("rope_theta", 1_000_000.0),
        rms_norm_eps=d.get("rms_norm_eps", 1e-6),
        max_position_embeddings=d.get("max_position_embeddings", 32768),
        tie_word_embeddings=d.get("tie_word_embeddings", False),
        use_sliding_window=bool(d.get("use_sliding_window", False)),
        sliding_window=d.get("sliding_window", 4096),
        max_window_layers=d.get("max_window_layers", d.get("num_hidden_layers", 28)),
    )
    image_size = 448 if "umt-hd" in str(d.get("mm_vision_tower", "umt-hd")) else 224
    vision = VisionConfig(
        image_size=image_size,
        num_frames=d.get("mm_local_num_frames", 4),
        return_idx=d.get("mm_vision_select_layer", -2),
    )
    return ModelConfig(
        llm=llm,
        vision=vision,
        mm_hidden_size=d.get("mm_hidden_size", 1024),
        mm_local_num_frames=d.get("mm_local_num_frames", 4),
        tokenizer_model_max_length=d.get("tokenizer_model_max_length"),
        tokenizer_padding_side=d.get("tokenizer_padding_side", "left"),
        mm_projector_type=d.get("mm_projector_type", "tome16_mlp_hd64"),
        vision_encode_type=d.get("vision_encode_type", "video_image"),
        mm_patch_merge_type=d.get("mm_patch_merge_type", "spatial_nopad"),
        mm_newline_position=d.get("mm_newline_position", "nothing"),
        mm_llm_compress=bool(d.get("mm_llm_compress", False)),
        llm_compress_type=d.get("llm_compress_type", "attention"),
        llm_compress_layer_list=tuple(d.get("llm_compress_layer_list", []) or []),
        llm_image_token_ratio_list=tuple(
            d.get("llm_image_token_ratio_list", [1.0]) or [1.0]
        ),
    )


def load_model_config(model_path: str) -> ModelConfig:
    """Load a ModelConfig from an HF checkpoint directory's config.json."""
    with open(os.path.join(model_path, "config.json")) as f:
        return from_hf_config_dict(json.load(f))
