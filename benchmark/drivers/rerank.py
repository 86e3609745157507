"""Rerank cells: back-to-back, closed-loop `evaluation` calls of
blim_tpu_torch (the top-k rerank of an MSRVTT-like test split in both
directions with CPN priors; with `has_tvg` the fine-tuned flow's six
matrices), each call whole and synchronized, on a fresh RerankEngine over
the same inputs, as a user's evaluation after each epoch runs.

Set-up makes the weights and inputs from --seed on the card, builds the
prefix-attention kernel, and runs one untimed evaluation of the cell's own
inputs, so that every pack bucket has run and the caching allocator holds
its blocks. A cell on more than one card runs a rank a card, each a
process in an NCCL group (launcher-style environment, a free port on
localhost); rank 0 is this process, decides for all when the window ends,
and prints.

With --trace 1 the window runs untraced as with --trace 0, and the
host-clock metrics (the pass walls, rerank_mfu) are read from it; one more
whole call follows under the profiler, for the device's idle share and
the breakdown (the profiler slows these host-paced calls by a third or
more).

`correct`: after the window, the matrices every timed call returned are
read at cells drawn from the seed and held to the plain float32 reference
(benchmark/reference/llm.py) computed on the same weights and inputs; and
every cell outside the top-k must hold the fill and every cell inside it a
finite score.
"""

from __future__ import annotations

import contextlib
import os
import socket
import sys
import time
from typing import Dict, List

import numpy as np

from benchmark import common, inputs as inputs_lib, trace as trace_lib, weights

FILL = -100.0
# matrix -> (direction of the pair list, kind): rows and columns of each
# (videos x captions for v2t, captions x videos for t2v)
MATRICES = {
    ("v2t", "candidate_likelihood"): ("v2t", "vtg"),
    ("t2v", "query_likelihood"): ("t2v", "vtg"),
    ("v2t", "candidate_prior"): ("v2t", "vtg_prior"),
    ("v2t", "query_likelihood"): ("v2t", "tvg"),
    ("t2v", "candidate_likelihood"): ("t2v", "tvg"),
    ("t2v", "candidate_prior"): ("t2v", "tvg_prior"),
}
PASSES = ("upload", "compute_vtg_priors_packed", "score_pairs_tvg_packed",
          "score_pairs_vtg_packed", "video_vocab")


def model_dict(config: Dict) -> Dict:
    """The reference's view of a configuration file."""
    d = dict(config)
    d.setdefault("head_dim", d["hidden_size"] // d["num_attention_heads"])
    return d


def matrices_of(has_tvg: bool, cpn: bool):
    keys = [k for k, (_, kind) in MATRICES.items()
            if (has_tvg or not kind.startswith("tvg")) and (cpn or not kind.endswith("prior"))]
    return keys


def sample_cells(inp: Dict, topk: int, keys, n_cells: int, seed: int) -> Dict:
    """Per matrix, cells (rows, cols) drawn from the seed among its top-k
    cells, with a cell of the longest caption first where it has one."""
    rng = np.random.default_rng(seed)
    lens = np.asarray([len(c) for c in inp["captions"]])
    longest = int(np.argmax(lens))
    out = {}
    for key in keys:
        direction = MATRICES[key][0]
        rows, cols = inputs_lib.topk_cells(inp[f"{direction}_iv2"], topk)
        caps = cols if direction == "v2t" else rows
        pick = list(rng.choice(len(rows), size=min(n_cells, len(rows)), replace=False))
        with_longest = np.nonzero(caps == longest)[0]
        if len(with_longest) and with_longest[0] not in pick:
            pick[0] = int(with_longest[0])
        pick = np.asarray(pick)
        out[key] = (rows[pick], cols[pick])
    return out


def pairs_of(key, rows, cols):
    """(caption, video, prior) of each sampled cell."""
    direction, kind = MATRICES[key]
    caps, vids = (cols, rows) if direction == "v2t" else (rows, cols)
    return [(int(c), int(v), kind.endswith("prior")) for c, v in zip(caps, vids)]


def fill_errors(mats: Dict, inp: Dict, topk: int, keys) -> int:
    """Cells outside the top-k not holding the fill, plus cells inside it
    holding the fill or a non-finite value, over the checked matrices."""
    bad = 0
    for key in keys:
        direction = MATRICES[key][0]
        m = mats[key[0]][key[1]]
        rows, cols = inputs_lib.topk_cells(inp[f"{direction}_iv2"], topk)
        inside = np.zeros(m.shape, bool)
        inside[rows, cols] = True
        bad += int(np.sum(inside & (~np.isfinite(m) | (m == FILL))))
        bad += int(np.sum(~inside & (m != FILL)))
    return bad


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(ctx: Dict) -> Dict:
    world = ctx["cell"]["workload"]["chips"]
    if world == 1:
        return body(ctx, 0, 1)
    import multiprocessing as mp

    port = free_port()
    env = {"WORLD_SIZE": str(world), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=body, args=(ctx, r, world, env), daemon=False)
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        return body(ctx, 0, world, env)
    finally:
        for p in procs:
            p.join(timeout=120)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


def body(ctx: Dict, rank: int, world: int, env: Dict = None) -> Dict:
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
    from blim_tpu_torch.data.prompts import make_tvg_layout, make_vtg_layout
    from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
    from blim_tpu_torch.engine.evaluation import EvalInputs, evaluation
    from blim_tpu_torch.engine.rerank import RerankEngine
    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.utils import distributed as dist

    cellx, seed, dev_kind = ctx["cell"], ctx["seed"], ctx.get("device", "cuda")
    if ctx.get("hook"):
        # tests: "module:function" run in every rank before set-up
        module, fn = ctx["hook"].split(":")
        getattr(__import__(module, fromlist=[fn]), fn)()
    traffic, config = cellx["traffic"], cellx["config"]
    if world > 1:
        os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank))
        dist.init_distributed_mode(device=dev_kind)
    device = torch.device(f"cuda:{rank}") if dev_kind == "cuda" else torch.device("cpu")
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
    params = weights.llm_tree(mdl, common.sub_seed(seed, 1), dtype, device)
    lora_cfg = config.get("lora")
    lora = (weights.lora_tree(mdl, lora_cfg, common.sub_seed(seed, 2), device)
            if lora_cfg else None)
    scale = lora_cfg["alpha"] / lora_cfg["r"] if lora_cfg else 0.0
    lap("weights")
    inp = inputs_lib.rerank_inputs(traffic, mdl, common.sub_seed(seed, 3),
                                   common.sub_seed(seed, 4), device)
    ev_inputs = EvalInputs(captions=inp["captions"], item_video_idx=inp["item_video_idx"],
                           features=inp["features"], t2v_iv2=inp["t2v_iv2"],
                           v2t_iv2=inp["v2t_iv2"])
    tok = ByteFallbackTokenizer()
    budget, has_tvg, cpn = traffic["caption_budget"], traffic["has_tvg"], traffic["cpn"]
    vtg_layout = make_vtg_layout(tok, traffic["dataset"], cfg.video_tokens_vtg,
                                 max_caption_tokens=budget)
    tvg_layout = make_tvg_layout(tok, cfg.num_clips, budget) if has_tvg else None
    lap("inputs")
    keys = matrices_of(has_tvg, cpn)
    cells = sample_cells(inp, traffic["topk"], keys, traffic["check_cells"],
                         common.sub_seed(seed, 5))
    spans = trace_lib.Spans()
    records: List[Dict] = []

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def evaluate(record: bool, traced: bool = False):
        engine = RerankEngine(params, cfg, vtg_layout, tvg_layout, lora=lora, lora_scale=scale,
                              device=device)
        if traced:
            for name in PASSES:
                setattr(engine, name, spans.wrap(getattr(engine, name), f"engine.{name}"))
        timings: Dict[str, float] = {}
        sync()
        with spans.span("evaluation") if traced else contextlib.nullcontext():
            t2v, v2t = evaluation(engine, ev_inputs, tok, traffic["dataset"],
                                  topk=traffic["topk"], cpn=cpn, has_tvg=has_tvg,
                                  verbose=False, timings=timings)
            sync()
        if record:
            mats = {"t2v": t2v, "v2t": v2t}
            records.append({
                "timings": timings, "steps": engine.steps,
                "prefix_forwards": engine.prefix_forwards,
                "tvg_prefix_forwards": engine.tvg_prefix_forwards,
                "flops": engine.flops, "useful_flops": engine.useful_flops,
                "values": {k: mats[k[0]][k[1]][r, c].copy() for k, (r, c) in cells.items()},
                "fill_errors": fill_errors(mats, inp, traffic["topk"], keys)})

    if ctx.get("warm", True):
        evaluate(record=False)
    sync()
    lap("warmup")
    setup_s = time.perf_counter() - t_start
    print(f"[{ctx['workload']}] rank {rank}: setup {setup_s:.3f} s = " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + f"; threads {torch.get_num_threads()}",
        flush=True, file=sys.stderr)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    def agree(go: bool) -> bool:
        if world == 1:
            return go
        flag = torch.tensor([1 if go else 0], device=device)
        torch.distributed.broadcast(flag, src=0)
        return bool(flag.item())

    spans_window = common.run_window(lambda: evaluate(True), ctx["seconds"], agree,
                                     clock=time.time)
    timed = list(records)
    reduced = None
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
    peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    mine = {"peak": peak_bytes, "flops": sum(r["flops"] for r in timed),
            "steps": sum(r["steps"] for r in timed),
            "pass_s": [_pass_seconds(r["timings"]) for r in timed],
            "busy_s": reduced["busy_s"] if reduced else None}
    gathered = [mine]
    if world > 1:
        gathered = [None] * world
        torch.distributed.all_gather_object(gathered, mine)
        dist.destroy_process_group()
    if rank != 0:
        return {}
    n, calls = traffic["queries"], len(timed)
    window_s = spans_window[-1][1] - spans_window[0][0]
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = compare(records, cells, params, mdl, inp, traffic, lora, scale, device)
    print(f"[{ctx['workload']}] reference check of {len(records)} call(s): "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr, flush=True)
    ok, checks = common.verdict(numbers, cellx["limits"])
    record = {"queries": n, "calls": calls, "window_s": window_s, "chips": world,
              "ranks": gathered, "useful_flops": records[0]["useful_flops"],
              "peak_flops": common.peak("bf16_flops", ctx["card"]["name"]) if cuda else None,
              "trace": reduced}
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
                   "count": world, "memory_peak_bytes": max(g["peak"] for g in gathered)}
    result = {"correct": ok, "attempted": n * len(records), "failed": 0, "metrics": metrics,
              "device": device_info}
    if reduced:
        busy = [g["busy_s"] for g in gathered]
        device_info.update(busy_s=sum(busy) / len(busy), window_s=reduced["window_s"])
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    out = {"result": result, "checks": checks}
    if ctx.get("keep_state"):
        out["state"] = {"params": params, "mdl": mdl, "inp": inp, "traffic": traffic,
                        "lora": lora, "scale": scale, "cells": cells, "device": device}
    return out


def compare(records, cells, params, mdl, inp, traffic, lora, scale, device) -> Dict[str, float]:
    """The largest |program - reference| of each direction's scores (VTG:
    likelihoods and CPN priors; TVG: the same) over every timed call's
    sampled cells, and the fill errors of every call."""
    import torch

    from benchmark.reference import llm as ref

    wanted = {}
    for key, (rows, cols) in cells.items():
        wanted.setdefault(MATRICES[key][1], set()).update(pairs_of(key, rows, cols))
    feats = torch.from_numpy(inp["features"]).to(device)
    values = {}
    with torch.no_grad(), ref.full_fp32():
        for kind, pairs in sorted(wanted.items()):
            pairs = sorted(pairs)
            if kind.startswith("vtg"):
                got = ref.vtg_scores(params, mdl, inp["captions"], feats, pairs,
                                     traffic["dataset"], traffic["caption_budget"], lora, scale)
            else:
                got = ref.tvg_scores(params, mdl, inp["captions"], feats, pairs,
                                     traffic["caption_budget"], lora, scale)
            values.update(((kind,) + p, v) for p, v in zip(pairs, got.cpu().tolist()))
    numbers = {f"{direction}_gap": 0.0 for direction in {k.split("_")[0] for k in wanted}}
    for rec in records:
        for key, (rows, cols) in cells.items():
            kind = MATRICES[key][1]
            want = np.asarray([values[(kind,) + p] for p in pairs_of(key, rows, cols)])
            gap = float(np.max(np.abs(rec["values"][key] - want)))
            name = f"{kind.split('_')[0]}_gap"
            numbers[name] = max(numbers[name], gap if np.isfinite(gap) else float("inf"))
    numbers["fill_errors"] = float(sum(rec["fill_errors"] for rec in records))
    return numbers



def _pass_seconds(t: Dict[str, float]) -> Dict[str, float]:
    """The evaluation's passes from its timing marks: the VTG pass with its
    priors, and both TVG passes (absent without TVG)."""
    start = t.get("upload_tvg", t["upload"])
    prior = t.get("prior_done", start)
    vtg = (prior - start) + (t["vtg_done"] - t.get("tvg_done", prior))
    out = {"vtg_s": vtg}
    if "tvg_done" in t:
        out["tvg_s"] = t["tvg_done"] - prior
    return out
