"""The expert products against their roofline: the bound time of the
traced call's grouped products (benchmark/flops_moe.py, from the rows the
call routed: the larger of operations over the bf16 peak and bytes over
the memory bandwidth, a product at a time) over their traced kernel time,
in percent; nothing without a traced mixture of experts."""


def read(record):
    trace = record.get("moe_trace")
    if not trace or not trace["expert_s"]:
        return None
    return 100.0 * trace["expert_bound_s"] / trace["expert_s"]
