"""The share of the MoE layer's device time that is not the experts' work:
the device time launched under the program's spans `moe.route` (router,
softmax, top-P), `moe.permute` (counting sort, gather) and `moe.combine`,
over that under all of the layer's spans (those, `moe.experts` and
`moe.shared`), in percent, over every layer and forward of one call of the
cell's inputs run eagerly and profiled after the traced call; nothing
without a traced mixture of experts or its spans."""

DISPATCH = ("moe.route", "moe.permute", "moe.combine")
LAYER = DISPATCH + ("moe.experts", "moe.shared")


def read(record):
    spans = (record.get("moe_trace") or {}).get("spans")
    layer = sum(spans.get(n, 0.0) for n in LAYER) if spans else 0.0
    if not layer:
        return None
    return 100.0 * sum(spans.get(n, 0.0) for n in DISPATCH) / layer
