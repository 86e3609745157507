#!/usr/bin/env python3
"""Where the host's time goes in a rerank cell of the benchmark: the port's
own spans (utils/profiling.py) and `RerankEngine.host_syncs`, read from a
run of the cell as `benchmark/run.py` makes it.

    python3 scripts/rerank_spans_torch.py --workload W --seed N [--seconds S]
        [--trace 0|1] [--tracer on|ab] [--out DIR]

runs `benchmark/run.py --workload W --seed N --seconds S --trace T` in this
process (its result line is printed as usual) with every `evaluation` call
wrapped: the tracer on in each call (`--tracer on`), or on and off in turns
on, off, off, on, ... across the window's calls (`--tracer ab`, to price
the tracer), always on in the warm-up and in the profiled call. Per call it
keeps the spans, `host_syncs`, `steps`, the step graphs' `graph_captures`
and `graph_replays`, the VTG pass wall from the `timings` marks, and the
window's own wall of the call. Under `--trace 1` the profiled call's idle
gaps are named twice, by the harness's spans alone (as the benchmark does)
and with the program's spans beside them (the innermost span around a gap
names it). The warm-up call runs once more
under `torch.cuda.set_sync_debug_mode("warn")`: the device syncs it warns
of, beside its `host_syncs`.

Then one JSON line: per window call (and for the warm-up, the cold call)
the graph captures, replays, replay share (replays / steps) and
`rerank.capture` self time; per traced window call and their mean, each
span's self time in ms a query, `host_syncs` a query, the share of the
call's wall that the `evaluation.*` and `rerank.*` spans' self times cover
and the root's own; with `ab`, the VTG pass ms a query with the tracer on and
off; with `--trace 1`, both idle-gap tables. With --out, the same line goes
to DIR/rerank_spans_<W>.json. Needs the CUDA cards the cell names.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# first: fixes the host's threads before torch loads, as a benchmark run does
from benchmark import run as bench_run  # noqa: E402
from benchmark import common, trace as trace_lib  # noqa: E402


class Recorder:
    """The wrapped calls' readings; `on(i)` says whether window call i
    (0-based, after the warm-up) runs with the tracer."""

    def __init__(self, mode: str):
        self.mode = mode
        self.calls = []            # one dict a wrapped evaluation call
        self.window = []           # (start, end) of each window call, time.time
        self.gaps = {}             # "harness" / "program" -> reduce() of the profiled call
        self.annotation_events = 0

    def on(self, i: int) -> bool:
        return self.mode == "on" or (i % 4) in (0, 3)


def instrument(rec: Recorder) -> None:
    """Wrap the program's evaluation, the benchmark's window and its
    profiled call's reduction (patches for this process)."""
    import torch
    from torch.autograd import profiler as torch_profiler

    from blim_tpu_torch.engine import evaluation as ev
    from blim_tpu_torch.utils import profiling

    real_eval, real_window, real_reduce = ev.evaluation, common.run_window, trace_lib.reduce

    def evaluation(engine, *args, **kwargs):
        profiled = torch_profiler._is_profiler_enabled
        warm = not rec.calls
        i = sum(1 for c in rec.calls if c["kind"] == "window")
        kind = "warm" if warm else "profiled" if profiled else "window"
        traced = kind != "window" or rec.on(i)
        tracer = profiling.Tracer()
        t0 = time.perf_counter()
        with profiling.tracing(tracer) if traced else contextlib.nullcontext():
            out = real_eval(engine, *args, **kwargs)
        wall = time.perf_counter() - t0
        call = {"kind": kind, "traced": traced, "wall_s": wall, "host_syncs": engine.host_syncs,
                "steps": engine.steps, "graph_captures": engine.graph_captures,
                "graph_replays": engine.graph_replays,
                "timings": dict(kwargs.get("timings") or {}), "spans": tracer.drain()}
        rec.calls.append(call)
        if warm and engine.device.type == "cuda":
            # once more with every device sync warned of
            from blim_tpu_torch.engine.rerank import RerankEngine

            again = RerankEngine(engine.params, engine.config, engine.vtg_layout,
                                 engine.tvg_layout, lora=engine.lora,
                                 lora_scale=engine.lora_scale, device=engine.device)
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    real_eval(again, *args, **dict(kwargs, timings={}))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            kinds = {}
            for w in seen:
                line = str(w.message).splitlines()[0][:120]
                kinds[line] = kinds.get(line, 0) + 1
            call["sync_debug"] = {"warnings": len(seen), "host_syncs": again.host_syncs,
                                  "kinds": kinds}
        return out

    def run_window(call, seconds, agree=lambda go: go, clock=time.perf_counter):
        def timed():
            start = time.time()
            call()
            rec.window.append((start, time.time()))
        return real_window(timed, seconds, agree, clock)

    def reduce(events, spans, window, kernel=None):
        program = [c for c in rec.calls if c["kind"] == "profiled"]
        names = {s.name for c in program for s in c["spans"]}
        rec.annotation_events = sum(1 for n, _, _ in events if n in names)
        rec.gaps["harness"] = real_reduce(events, spans, window, kernel)
        mine = [(s.name, s.start_ns, s.end_ns) for c in program for s in c["spans"]]
        rec.gaps["program"] = real_reduce(events, list(spans) + mine, window, kernel)
        return rec.gaps["harness"]

    ev.evaluation = evaluation
    common.run_window = run_window
    trace_lib.reduce = reduce


def graphs_of(call) -> dict:
    """A call's step graphs: captures, replays, the replay share of its
    steps, and the `rerank.capture` self time (ms, traced calls only)."""
    from blim_tpu_torch.utils import profiling

    out = {k: call[k] for k in ("graph_captures", "graph_replays")}
    out["replay_share"] = call["graph_replays"] / call["steps"] if call["steps"] else None
    if call["traced"]:
        out["capture_ms"] = profiling.self_times(call["spans"]).get("rerank.capture", 0) / 1e6
    return out


def summarize(rec: Recorder, queries: int) -> dict:
    from blim_tpu_torch.utils import profiling

    window = [c for c in rec.calls if c["kind"] == "window"]
    per_call = []
    for c, (start, end) in zip(window, rec.window):
        row = {"traced": c["traced"], "wall_s": end - start, "host_syncs": c["host_syncs"],
               "steps": c["steps"], **graphs_of(c),
               "vtg_pass_ms_per_query": 1e3 * _vtg_pass_s(c["timings"]) / queries}
        if c["traced"]:
            self_ns = profiling.self_times(c["spans"])
            row["self_ms_per_query"] = {k: v / 1e6 / queries for k, v in sorted(self_ns.items())}
            inner = sum(v for k, v in self_ns.items() if k != "evaluation")
            row["covered_share"] = inner / 1e9 / (end - start)
            row["root_self_share"] = self_ns.get("evaluation", 0) / 1e9 / (end - start)
        per_call.append(row)
    traced = [r for r in per_call if r["traced"]]
    out = {"queries": queries, "calls": per_call}
    if traced:
        names = sorted({k for r in traced for k in r["self_ms_per_query"]})
        out["mean_self_ms_per_query"] = {
            k: sum(r["self_ms_per_query"].get(k, 0.0) for r in traced) / len(traced)
            for k in names}
        m = out["mean_self_ms_per_query"]
        out["dispatch_ms_per_query"] = m.get("rerank.dispatch")
        out["host_wait_ms_per_query"] = m.get("rerank.upload", 0.0) + m.get("rerank.readback",
                                                                              0.0)
        out["host_syncs_per_query"] = sum(r["host_syncs"] for r in traced) / len(traced) / queries
        out["covered_share_min"] = min(r["covered_share"] for r in traced)
        out["root_self_share_max"] = max(r["root_self_share"] for r in traced)
    if rec.mode == "ab":
        for flag in (True, False):
            vals = [r["vtg_pass_ms_per_query"] for r in per_call if r["traced"] == flag]
            out[f"vtg_pass_ms_per_query_tracer_{'on' if flag else 'off'}"] = vals
    warm = next((c for c in rec.calls if c["kind"] == "warm"), None)
    if warm is not None:
        out["warm_graphs"] = graphs_of(warm)
    if warm is not None and "sync_debug" in warm:
        out["warm_sync_debug"] = warm["sync_debug"]
    if rec.gaps:
        out["annotation_events_in_the_device_trace"] = rec.annotation_events
        for key, red in rec.gaps.items():
            out[f"idle_gaps_{key}"] = red["idle_gaps"]
        red = rec.gaps["program"]
        idle = red["window_s"] - red["busy_s"]
        named = sum(v for k, v in red["idle_gaps"]
                    if k.startswith(("rerank.", "evaluation.")))
        out["idle_s"] = idle
        out["idle_share_under_program_spans"] = named / idle if idle else None
    return out


def _vtg_pass_s(t) -> float:
    start = t.get("upload_tvg", t["upload"])
    prior = t.get("prior_done", start)
    return (prior - start) + (t["vtg_done"] - t.get("tvg_done", prior))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--tracer", choices=("on", "ab"), default="on")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = Recorder(args.tracer)
    instrument(rec)
    rc = bench_run.main(["--workload", args.workload, "--seed", str(args.seed),
                         "--seconds", str(args.seconds), "--trace", str(args.trace)])
    if rc:
        return rc
    queries = common.cell(common.spec(ROOT), args.workload)["traffic"]["queries"]
    line = json.dumps({"workload": args.workload, "seed": args.seed,
                       **summarize(rec, queries)})
    print(line)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / f"rerank_spans_{args.workload}.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
