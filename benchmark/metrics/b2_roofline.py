"""Kernel B2 (flash_fwd_dense, the ViT's dense attention) against its
roofline: the least time of one call's attention (all clips of a batch,
the tower's sequence, heads and head dim; the larger of its operations
over the bf16 peak and its bytes over the memory bandwidth,
benchmark/flops.py) over B2's mean traced time a launch, in percent."""

from benchmark import common, flops


def read(record):
    trace = record["trace"]
    if trace is None or not trace.get("kernel_mean_s"):
        return None
    v = record["vision"]["vision"]
    side = v["image_size"] // v["patch_size"]
    name = record["card"]["name"]
    bound = flops.attention_bound_s(
        record["videos_per_call"] * record["clips"], record["frames_per_clip"] * side * side,
        v["num_attention_heads"], v["hidden_size"] // v["num_attention_heads"],
        common.peak("bf16_flops", name), common.peak("hbm_bytes", name))["bound_s"]
    return 100.0 * bound / trace["kernel_mean_s"]
