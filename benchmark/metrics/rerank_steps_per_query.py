"""RerankEngine steps (pack batches dispatched, engine.steps) of every
rank, a query of one evaluation."""


def read(record):
    return sum(r["steps"] for r in record["ranks"]) / record["calls"] / record["queries"]
