"""The engine's packing efficiency: the request's zero-waste FLOPs
(engine.useful_flops, one evaluation) over the FLOPs every rank's steps
dispatched (engine.flops), in percent."""


def read(record):
    dispatched = sum(r["flops"] for r in record["ranks"])
    if not dispatched:
        return None
    return 100.0 * record["useful_flops"] * record["calls"] / dispatched
