"""Operations and bytes of a mixture of experts' expert products, from the
rows the program routed: per layer and forward, two grouped products in
bf16, gate and up side by side (hidden x 2 width) and down (width x
hidden), each expert multiplying only its own rows."""

from __future__ import annotations

from typing import Dict, Sequence


def expert_products(rows: Sequence[int], hidden: int, width: int, itemsize: int = 2) -> Dict:
    """ops and bytes of one layer's two grouped products for rows[e] rows
    routed to expert e: 2 per multiply-add; each expert with rows has its
    weights read once, each row's input read once and output written once."""
    r = float(sum(rows))
    active = sum(1 for x in rows if x)
    gate_up = {"ops": 2.0 * r * hidden * 2 * width,
               "bytes": itemsize * (active * hidden * 2 * width + r * (hidden + 2 * width))}
    down = {"ops": 2.0 * r * width * hidden,
            "bytes": itemsize * (active * width * hidden + r * (width + hidden))}
    return {"gate_up": gate_up, "down": down}


def expert_bound_s(rows: Sequence[int], hidden: int, width: int, peak_flops: float,
                   peak_bytes: float) -> float:
    """The least time of one layer's two grouped products: for each, the
    larger of its operations over the peak rate and its bytes over the
    memory bandwidth."""
    return sum(max(p["ops"] / peak_flops, p["bytes"] / peak_bytes)
               for p in expert_products(rows, hidden, width).values())
