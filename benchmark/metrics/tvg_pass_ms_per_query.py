"""Wall milliseconds a query of both TVG packed passes (score and CPN
prior, score_pairs_tvg_packed), rank 0, mean over the window's calls;
nothing where the cell runs no TVG."""


def read(record):
    calls = record["ranks"][0]["pass_s"]
    if "tvg_s" not in calls[0]:
        return None
    return 1e3 * sum(c["tvg_s"] for c in calls) / len(calls) / record["queries"]
