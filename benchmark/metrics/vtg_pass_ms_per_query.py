"""Wall milliseconds a query of the VTG pass with its CPN priors
(engine/evaluation.py's marks: compute_vtg_priors_packed and
score_pairs_vtg_packed, each ending in a host copy), rank 0, mean over the
window's calls."""


def read(record):
    calls = record["ranks"][0]["pass_s"]
    return 1e3 * sum(c["vtg_s"] for c in calls) / len(calls) / record["queries"]
