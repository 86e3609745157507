"""The slowest rank's VTG + TVG pass wall over the ranks' mean, a call,
mean over the window's calls; nothing on one card."""


def read(record):
    ranks = record["ranks"]
    if len(ranks) < 2:
        return None
    skews = []
    for c in range(record["calls"]):
        walls = [r["pass_s"][c]["vtg_s"] + r["pass_s"][c].get("tvg_s", 0.0) for r in ranks]
        skews.append(max(walls) / (sum(walls) / len(walls)))
    return sum(skews) / len(skews)
