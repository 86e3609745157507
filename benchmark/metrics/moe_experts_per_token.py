"""Computing (routed, not null) experts per real token of the mixture of
experts, over all layers and the window's calls: the program's routed rows
of real tokens (RerankEngine.moe_rows) over its real token-layers
(moe_tokens); nothing where the cell runs no mixture of experts."""


def read(record):
    moe = record.get("moe")
    if not moe or not moe["tokens"].sum():
        return None
    return float(moe["rows"][:, : moe["routed"]].sum() / moe["tokens"].sum())
