"""The featurizer's share of the card's bf16 peak: the benchmark's own
FLOP count of a clip (patch embedding, the tower's blocks, ToMe's
similarity products; benchmark/flops.py) times the clips of the window's
videos, over the window's wall time and the peak, in percent."""

from benchmark import common, flops


def read(record):
    vd = record["vision"]
    target = vd["tokens_per_frame"] * record["frames_per_clip"]
    per_clip = flops.vit_clip_flops(vd["vision"], record["frames_per_clip"], target)
    rate = per_clip * record["clips"] * record["videos"] / record["window_s"]
    return 100.0 * rate / common.peak("bf16_flops", record["card"]["name"])
