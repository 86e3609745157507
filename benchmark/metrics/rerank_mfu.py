"""The whole evaluation's share of the cards' bf16 peak: the request's
useful FLOPs (engine.useful_flops) of every call in the window over the
window's wall time and (cards x peak), in percent."""


def read(record):
    if not record["peak_flops"]:
        return None
    rate = record["useful_flops"] * record["calls"] / record["window_s"]
    return 100.0 * rate / (record["chips"] * record["peak_flops"])
