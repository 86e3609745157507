"""Percent of the traced window in which no kernel, copy or set ran on a
card (1 - the union of device activity / the window), mean over the
cards."""


def read(record):
    trace = record["trace"]
    busy = [r["busy_s"] for r in record["ranks"]]
    if trace is None or None in busy:
        return None
    return 100.0 * (1.0 - sum(busy) / len(busy) / trace["window_s"])
