"""Rerank cells of a mixture-of-experts configuration (Uni-MoE-2.0-Omni's
language model): the closed loop of `rerank.py`, whole synchronized
`evaluation` calls of blim_tpu_torch on a fresh RerankEngine, on one card,
with the weights of `weights_moe.py` and the same record keys, so the
rerank readers read it; the engine's routing log gives each step's
decisions.

`correct`: after the window, every timed call's sampled cells are held to
the plain float32 reference (benchmark/reference/moe_llm.py) routed by the
decisions the program logged for each checked pair in that call (calls
whose decisions for the checked pairs are equal to the bit share one
reference run): `vtg_gap` (scores and CPN priors), `fill_errors`, and
`route_shortfall`, the largest amount of probability by which a logged
decision lies on the wrong side of the top-P rule, judged on the
reference's float32 router probabilities.

With --trace 1, besides the rerank cells' trace of one more call (its
steps replayed from their graphs): the expert products' traced time (the
grouped GEMM's kernels, by name) against their bound from that call's
logged rows (benchmark/flops_moe.py); and one more call of the same inputs
with the step graphs set aside (the program's `step_graphs.eager()`) and
its tracer on, profiled for CUDA activity, whose device time is put under
the MoE layer's spans (`moe.route`, `moe.permute`, `moe.experts`,
`moe.shared`, `moe.combine`) over every layer and forward: a device
activity belongs to the span in which the host's runtime call that
launched it started. A replayed graph ties no kernel to a span.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import sys
import time
from typing import Dict, List

import numpy as np

from benchmark import common, flops_moe, inputs as inputs_lib, trace as trace_lib, weights_moe
from benchmark.drivers.rerank import (PASSES, _pass_seconds, fill_errors, matrices_of, model_dict,
                                      pairs_of, sample_cells)

# kernel-name fragments of the expert products: CUTLASS's grouped GEMM
# (`torch._grouped_mm`) and the kernel that sets up its groups
EXPERT_KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")
# the MoE layer's spans in the program (models/moe.py)
MOE_SPANS = ("moe.route", "moe.permute", "moe.experts", "moe.shared", "moe.combine")


def run(ctx: Dict) -> Dict:
    if ctx["cell"]["workload"]["chips"] != 1:
        raise ValueError("rerank_moe runs on one card")
    if importlib.util.find_spec("blim_tpu_torch.models.moe") is None:
        raise RuntimeError("the program has no mixture-of-experts decoder "
                           "(blim_tpu_torch.models.moe)")
    return body(ctx)


def body(ctx: Dict) -> Dict:
    t_start = ctx["t_start"]
    split = {}
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        now = time.perf_counter()
        split[name] = now - mark
        mark = now

    import torch

    from blim_tpu_torch.core.config import from_hf_config_dict
    from blim_tpu_torch.data.prompts import make_vtg_layout
    from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
    from blim_tpu_torch.engine.evaluation import EvalInputs, evaluation
    from blim_tpu_torch.engine.rerank import RerankEngine
    from blim_tpu_torch.kernels import flash_attention as fa

    cellx, seed, dev_kind = ctx["cell"], ctx["seed"], ctx.get("device", "cuda")
    traffic, config = cellx["traffic"], cellx["config"]
    if traffic["has_tvg"]:
        raise ValueError("rerank_moe runs the VTG directions (no TVG)")
    device = torch.device("cuda:0") if dev_kind == "cuda" else torch.device("cpu")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
    lap("imports_and_context")
    if cuda:
        fa.build(("flash_fwd",))
    lap("kernels")
    cfg = from_hf_config_dict(config)
    mdl = model_dict(config)
    dtype = torch.bfloat16 if config["torch_dtype"] == "bfloat16" else torch.float32
    params = weights_moe.llm_tree(mdl, common.sub_seed(seed, 1), dtype, device)
    lap("weights")
    inp = inputs_lib.rerank_inputs(traffic, mdl, common.sub_seed(seed, 3),
                                   common.sub_seed(seed, 4), device)
    ev_inputs = EvalInputs(captions=inp["captions"], item_video_idx=inp["item_video_idx"],
                           features=inp["features"], t2v_iv2=inp["t2v_iv2"],
                           v2t_iv2=inp["v2t_iv2"])
    tok = ByteFallbackTokenizer()
    vtg_layout = make_vtg_layout(tok, traffic["dataset"], cfg.video_tokens_vtg,
                                 max_caption_tokens=traffic["caption_budget"])
    lap("inputs")
    keys = matrices_of(False, traffic["cpn"])
    cells = sample_cells(inp, traffic["topk"], keys, traffic["check_cells"],
                         common.sub_seed(seed, 5))
    spans = trace_lib.Spans()
    records: List[Dict] = []

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def evaluate(record: bool, traced: bool = False):
        engine = RerankEngine(params, cfg, vtg_layout, None, device=device)
        if traced:
            for name in PASSES:
                setattr(engine, name, spans.wrap(getattr(engine, name), f"engine.{name}"))
        timings: Dict[str, float] = {}
        sync()
        with spans.span("evaluation") if traced else contextlib.nullcontext():
            t2v, v2t = evaluation(engine, ev_inputs, tok, traffic["dataset"],
                                  topk=traffic["topk"], cpn=traffic["cpn"], has_tvg=False,
                                  verbose=False, timings=timings)
            sync()
        if record:
            mats = {"t2v": t2v, "v2t": v2t}
            records.append({
                "timings": timings, "steps": engine.steps,
                "prefix_forwards": engine.prefix_forwards,
                "flops": engine.flops, "useful_flops": engine.useful_flops,
                "moe": {"rows": engine.moe_rows, "tokens": engine.moe_tokens,
                        "rows_other": engine.moe_rows_other,
                        "tokens_other": engine.moe_tokens_other},
                "routing": (engine.routing_log, engine.routing_prior_prefix),
                "values": {k: mats[k[0]][k[1]][r, c].copy() for k, (r, c) in cells.items()},
                "fill_errors": fill_errors(mats, inp, traffic["topk"], keys)})

    if ctx.get("warm", True):
        evaluate(record=False)
    sync()
    lap("warmup")
    setup_s = time.perf_counter() - t_start
    print(f"[{ctx['workload']}] setup {setup_s:.3f} s = " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + f"; threads {torch.get_num_threads()}",
        flush=True, file=sys.stderr)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    spans_window = common.run_window(lambda: evaluate(True), ctx["seconds"], clock=time.time)
    timed = list(records)
    reduced = moe_trace = None
    peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    if ctx["trace"]:
        with trace_lib.device_profile(cuda) as prof:
            start = time.time()
            evaluate(True, traced=True)
            end = time.time()
        if cuda:
            print(f"[{ctx['workload']}] profiler: start {prof['start_s']:.1f} s, stop "
                  f"{prof['stop_s']:.1f} s, read {prof['read_s']:.1f} s, "
                  f"{len(prof['events'])} device events", file=sys.stderr, flush=True)
            window = (int(start * 1e9), int(end * 1e9))
            reduced = trace_lib.reduce(prof["events"], spans.items, window)
            moe_trace = expert_trace(prof["events"], window, records[-1]["routing"], mdl,
                                     ctx["card"]["name"])
            moe_trace["spans"] = eager_span_seconds(lambda: evaluate(False), MOE_SPANS)
            print(f"[{ctx['workload']}] MoE trace: {moe_trace}", file=sys.stderr, flush=True)
    mine = {"peak": peak_bytes, "flops": sum(r["flops"] for r in timed),
            "steps": sum(r["steps"] for r in timed),
            "pass_s": [_pass_seconds(r["timings"]) for r in timed],
            "busy_s": reduced["busy_s"] if reduced else None}
    n, calls = traffic["queries"], len(timed)
    window_s = spans_window[-1][1] - spans_window[0][0]
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = compare(records, cells, params, mdl, inp, traffic, vtg_layout, device)
    print(f"[{ctx['workload']}] reference check of {len(records)} call(s): "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr, flush=True)
    ok, checks = common.verdict(numbers, cellx["limits"])
    moe_counts = {k: sum(r["moe"][k] for r in timed) for k in timed[0]["moe"]}
    record = {"queries": n, "calls": calls, "window_s": window_s, "chips": 1,
              "ranks": [mine], "useful_flops": records[0]["useful_flops"],
              "peak_flops": common.peak("bf16_flops", ctx["card"]["name"]) if cuda else None,
              "trace": reduced, "moe": dict(moe_counts, routed=mdl["mlp_dynamic_expert_num"]),
              "moe_trace": moe_trace}
    if ctx["trace"]:
        metrics = {}
        for m in cellx["per_layer"]:
            value = common.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = common.metric(value, m["unit"])
    else:
        metrics = {"rerank_qps": common.metric(n * calls / window_s, "queries/s"),
                   "setup_s": common.metric(setup_s, "s")}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": ctx["card"]["name"],
                   "count": 1, "memory_peak_bytes": peak_bytes}
    result = {"correct": ok, "attempted": n * len(records), "failed": 0, "metrics": metrics,
              "device": device_info}
    if reduced:
        device_info.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    out = {"result": result, "checks": checks}
    if ctx.get("keep_state"):
        out["state"] = {"params": params, "mdl": mdl, "inp": inp, "traffic": traffic,
                        "cells": cells, "device": device, "records": records,
                        "vtg_layout": vtg_layout}
    return out


def pair_routes(routing, pairs, vtg_layout) -> List:
    """Each (caption, video, prior) pair's logged decisions, laid out as the
    reference's sequence: (L, T, top_k) int8 on the device; the prior's
    invisible video tokens FREE. (Any per-token log of the routing log's
    layout, (L, g, n, ...), lays out the same way.)"""
    import torch

    from benchmark.reference.moe_llm import FREE

    log, prior_prefix = routing
    where = {}
    for entry in log:
        if entry["pass"] not in ("vtg", "vtg_prior"):
            continue
        prior = entry["pass"] == "vtg_prior"
        for r, caps in enumerate(entry["captions"]):
            for si, c in enumerate(caps):
                key = (int(c), None, True) if prior else (int(c), int(entry["rows"][0][r]), False)
                where.setdefault(key, (entry, r, si))
    P = vtg_layout.prefix_len
    out = []
    for cap, vid, prior in pairs:
        entry, r, si = where[(cap, None, True) if prior else (cap, vid, False)]
        segs = entry["rows"][1 if prior else 2][r]
        suffix = entry["suffix"][:, r][:, torch.from_numpy(np.nonzero(segs == si)[0]).to(
            entry["suffix"].device)]
        if prior:
            L, _, K = prior_prefix.shape
            prefix = prior_prefix.new_full((L, P, K), FREE)
            pos = torch.from_numpy(vtg_layout.prior_prefix()[1].astype(np.int64))
            prefix[:, pos.to(prefix.device)] = prior_prefix
        else:
            prefix = entry["prefix"][:, r]
        out.append(torch.cat([prefix, suffix], 1))
    return out


def compare(records, cells, params, mdl, inp, traffic, vtg_layout, device, quant=None
            ) -> Dict[str, float]:
    """vtg_gap, route_shortfall and fill_errors over every timed call (see
    the module's docstring); with `quant` the reference's own side, routed by
    its own probabilities, is the program (the control)."""
    import torch

    from benchmark.reference import llm as ref_llm
    from benchmark.reference import moe_llm as ref

    pairs = sorted({p for key, (rows, cols) in cells.items() for p in pairs_of(key, rows, cols)})
    feats = torch.from_numpy(inp["features"]).to(device)
    top_p = mdl["mlp_dynamic_top_p"]
    args = (params, mdl, inp["captions"], feats, pairs, traffic["dataset"],
            traffic["caption_budget"])
    numbers = {"vtg_gap": 0.0, "route_shortfall": 0.0}
    done = []          # (decisions, values) of each distinct set of routes
    with torch.no_grad(), ref_llm.full_fp32():
        for rec in records:
            routes = pair_routes(rec["routing"], pairs, vtg_layout)
            hit = next((vals for dec, vals in done
                        if all(torch.equal(a, b) for a, b in zip(dec, routes))), None)
            if hit is None:
                log: List = []
                want = ref.vtg_scores(*args, decisions=routes, record=log).cpu().tolist()
                short = max(ref.route_shortfall(p, d, top_p) for pair in log for p, d in pair)
                hit = (dict(zip(pairs, want)), short)
                done.append((routes, hit))
            values, short = hit
            numbers["route_shortfall"] = max(numbers["route_shortfall"], short)
            for key, (rows, cols) in cells.items():
                want = np.asarray([values[p] for p in pairs_of(key, rows, cols)])
                gap = float(np.max(np.abs(rec["values"][key] - want)))
                numbers["vtg_gap"] = max(numbers["vtg_gap"], gap if np.isfinite(gap) else np.inf)
    numbers["fill_errors"] = float(sum(rec["fill_errors"] for rec in records))
    return numbers


def expert_trace(events, window, routing, mdl: Dict, card: str) -> Dict:
    """The expert products of the traced call: their kernels' time and
    launches, and their bound from the rows the call routed (every logged
    forward, padding included: what the products computed)."""
    w0, w1 = window
    times = [(e - s) / 1e9 for n, s, e in events
             if e > w0 and s < w1 and any(k in n for k in EXPERT_KERNELS)]
    bound = sum(flops_moe.expert_bound_s(layer_rows, mdl["hidden_size"],
                                         mdl["dynamic_intermediate_size"],
                                         common.peak("bf16_flops", card),
                                         common.peak("hbm_bytes", card))
                for rows in logged_rows(routing, mdl["mlp_dynamic_expert_num"])
                for layer_rows in rows)
    return {"expert_s": sum(times), "expert_kernels": len(times), "expert_bound_s": bound}


def logged_rows(routing, n_routed: int):
    """Per logged forward (each packed step's prefix and suffix, the prior
    prefix): its routed rows per layer and expert, (L, E) numpy."""
    import torch

    log, prior_prefix = routing
    decs = [d for e in log for d in (e["prefix"], e["suffix"]) if d is not None]
    if prior_prefix is not None:
        decs.append(prior_prefix[:, None])
    for d in decs:
        d = d.long()
        yield (d[..., None] == torch.arange(n_routed, device=d.device)).sum(
            dim=tuple(range(1, d.dim()))).cpu().numpy()


def eager_span_seconds(run, names) -> Dict[str, float]:
    """Device seconds under each of the program's spans `names` over one
    `run()` with the step graphs set aside, the program's tracer on and
    torch.profiler recording CUDA activity (kernels, copies and sets, and
    the host's calls into the CUDA runtime that launched them)."""
    from torch.profiler import ProfilerActivity, profile

    from blim_tpu_torch.engine import step_graphs
    from blim_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    with step_graphs.eager(), profiling.tracing() as tracer:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
    t1 = time.perf_counter()
    spans = [(sp.start_ns, sp.end_ns, sp.name) for sp in tracer.drain() if sp.name in names]
    events = prof.profiler.kineto_results.events()
    out = span_device_seconds(spans, kineto_rows(events), names)
    print(f"eager profiled call {t1 - t0:.1f} s, {len(events)} events read and put under "
          f"{len(spans)} spans in {time.perf_counter() - t1:.1f} s", file=sys.stderr, flush=True)
    return out


def kineto_rows(events):
    """torch.profiler's raw events of a CUDA-activity profile as
    (on_device, start_ns, end_ns, correlation id): the device's activities
    (user annotations left out) and the host's runtime calls, which share
    their correlation id with the activity they launched."""
    for e in events:
        on_device = e.device_type() != e.device_type().__class__.CPU
        if on_device and getattr(e, "is_user_annotation", bool)():
            continue
        yield on_device, e.start_ns(), e.end_ns(), e.correlation_id()


def span_device_seconds(spans, rows, names) -> Dict[str, float]:
    """The device seconds of the activities launched inside each span of
    `names` ((start_ns, end_ns, name) host ranges on the profiler's clock
    that do not nest in one another), and "total", of every device
    activity. Rows as `kineto_rows` gives them: a device activity belongs
    to the span in which the runtime call of its correlation id started."""
    launch, device = {}, []
    for on_device, start, end, corr in rows:
        if on_device:
            device.append((corr, end - start))
        else:
            launch[corr] = start
    ranges = sorted(spans)
    begins = [r[0] for r in ranges]
    out = dict.fromkeys(names, 0.0)
    out["total"] = 0.0
    for corr, ns in device:
        out["total"] += ns / 1e9
        t = launch.get(corr)
        i = -1 if t is None else bisect.bisect_right(begins, t) - 1
        if i >= 0 and t < ranges[i][1]:
            out[ranges[i][2]] += ns / 1e9
    return out
