"""Tiny cells for the benchmark's CPU tests: the committed configurations
and traffic mixes cut to a size the CPU runs in seconds (a 2-layer, 64-wide
decoder and 8 queries; a 2-block tower on one clip of 224-pixel frames), in
float32, so the program and the reference agree to rounding."""

from __future__ import annotations

import time
from typing import Dict

from benchmark import common

# float32 on both sides at the tiny size: rounding only (~1e-5)
TINY_LIMIT = 1e-3


def rerank_cell(finetuned: bool = True, chips: int = 1) -> Dict:
    name = "blim-lora-r8-qwen2-7b-res448" if finetuned else "videochat-flash-qwen2-7b-res448"
    cfg = common.load_json(common.HERE / "configs" / f"{name}.json")
    cfg.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, mm_hidden_size=32,
               torch_dtype="float32")
    traffic = common.load_json(common.HERE / "traffic" / (
        "msrvtt256-topk16-ft.json" if finetuned else "msrvtt256-topk16-zs.json"))
    traffic.update(queries=8, topk=2, check_cells=3)
    directions = ["vtg"] + (["tvg"] if finetuned else [])
    limits = {f"{d}_gap": {"limit": TINY_LIMIT} for d in directions}
    limits["fill_errors"] = {"limit": 0}
    return {"workload": {"name": "tiny", "chips": chips}, "config": cfg, "traffic": traffic,
            "limits": limits, "per_layer": [], "end_to_end": []}


def extract_cell() -> Dict:
    cfg = common.load_json(common.HERE / "configs" / "videochat-flash-qwen2-7b-res448.json")
    cfg.update(torch_dtype="float32", mm_vision_tower="umt-large", mm_vision_select_layer=-23)
    cfg["vision"] = dict(cfg["vision"], image_size=224)
    traffic = common.load_json(common.HERE / "traffic" / "msrvtt-b16-240x320.json")
    traffic.update(videos_per_call=1, clips=1, pool_calls=2, warm_calls=1, check_videos=1,
                   frame_hw=[120, 160])
    limits = {name: {"limit": TINY_LIMIT} for name in ("feature_rel_err", "merge_shortfall")}
    return {"workload": {"name": "tiny", "chips": 1}, "config": cfg, "traffic": traffic,
            "limits": limits, "per_layer": [], "end_to_end": []}


def context(cellx: Dict, seconds: float = 0.5, seed: int = 2**31 + 7, trace: int = 0) -> Dict:
    return {"root": str(common.ROOT), "workload": "tiny", "seed": seed, "seconds": seconds,
            "trace": trace, "t_start": time.perf_counter(), "cell": cellx,
            "card": {"name": "cpu", "power_limit": None}, "device": "cpu"}
