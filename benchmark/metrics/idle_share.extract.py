"""Percent of the traced window in which no kernel, copy or set ran on
the card (1 - the union of device activity / the window)."""


def read(record):
    trace = record["trace"]
    if trace is None:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
