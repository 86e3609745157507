"""Extraction cells: back-to-back calls of the featurizer that
blim_tpu_torch's `make_featurizer(..., device_preprocess=True)` returns,
each on a batch of seeded uint8 video frames uploaded from pinned host
memory (the resize to the tower's resolution and the normalisation on the
card, the ViT-L tower through its dense attention kernel, ToMe), each call
whole and synchronized. The batches cycle through a pool made in set-up.

Set-up makes the tower's weights and the frame pool from --seed on the
card, builds the dense attention kernel and runs the featurizer on the
pool's first batches untimed.

`correct`: the features of pool videos drawn from the seed, as every timed
call that held them returned them, are held to the plain float32
reference (benchmark/reference/vit.py) on the same weights and frames,
merged by the program's own ToMe decisions (kept from the timed calls by
a wrapper around the program's merge-index function); and those decisions
are held by themselves to ToMe's rule (see `compare`).
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List

import numpy as np

from benchmark import common, inputs as inputs_lib, trace as trace_lib, weights

KERNEL = "flash_fwd_dense"


def vision_dict(config: Dict) -> Dict:
    """The reference's view of a configuration file's vision tower."""
    v = dict(config["vision"])
    v["depth"] = v["num_hidden_layers"] + config["mm_vision_select_layer"] + 1
    return {"vision": v, "tokens_per_frame": config["tokens_per_frame"]}


def run(ctx: Dict) -> Dict:
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
    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.models import projector
    from blim_tpu_torch.pipelines.extract import make_featurizer

    cellx, seed = ctx["cell"], ctx["seed"]
    traffic, config = cellx["traffic"], cellx["config"]
    device = torch.device("cuda:0" if ctx.get("device", "cuda") == "cuda" else "cpu")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
    # the on-card resize refuses TF32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    lap("imports_and_context")
    if cuda:
        fa.build((KERNEL,))
    lap("kernels")
    cfg = from_hf_config_dict(config)
    vd = vision_dict(config)
    dtype = torch.bfloat16 if config["torch_dtype"] == "bfloat16" else torch.float32
    vit = weights.vit_tree(vd["vision"], common.sub_seed(seed, 1), dtype, device)
    lap("weights")
    per_call, pool_calls = traffic["videos_per_call"], traffic["pool_calls"]
    frames = inputs_lib.video_frames(traffic, per_call * pool_calls, common.sub_seed(seed, 2),
                                     device)
    host = frames.cpu()
    if cuda:
        host = host.pin_memory()
    pool = [host[i * per_call: (i + 1) * per_call] for i in range(pool_calls)]
    rng = np.random.default_rng(common.sub_seed(seed, 3))
    checked = sorted(rng.choice(per_call * pool_calls, size=traffic["check_videos"],
                                replace=False).tolist())
    featurize = make_featurizer(vit, cfg, device=device, device_preprocess=True)
    clips = traffic["clips"]
    # per pool batch: its checked videos and their clips' rows in a call
    mine_of = [[v for v in checked if v // per_call == b] for b in range(pool_calls)]
    rows_of = [torch.as_tensor([(v % per_call) * clips + c for v in mine for c in range(clips)],
                               device=device) if mine else None for mine in mine_of]
    lap("inputs")
    spans = trace_lib.Spans()
    kept: Dict[int, List] = {v: [] for v in checked}
    state = {"i": 0, "rows": None, "rounds": []}
    real_indices = projector._bipartite_merge_indices

    def indices(metric, r):
        """The program's ToMe round, its decisions and metric kept for
        the checked videos' clips."""
        unm, src, dst = real_indices(metric, r)
        rows = state["rows"]
        if rows is not None:
            state["rounds"].append((metric[rows].clone(), r, unm[rows].clone(),
                                    src[rows].clone(), dst[rows].clone()))
        return unm, src, dst

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def call(record: bool, traced: bool = False):
        b = state["i"] % pool_calls
        state["i"] += 1
        mine = mine_of[b] if record else []
        state["rows"] = rows_of[b] if record else None
        state["rounds"] = []
        with spans.span("featurizer") if traced else contextlib.nullcontext():
            with spans.span("upload") if traced else contextlib.nullcontext():
                x = pool[b].to(device, non_blocking=True)
            out = featurize(x)
            sync()
        for k, v in enumerate(mine):
            part = slice(k * clips, (k + 1) * clips)
            kept[v].append((out[v % per_call].clone(),
                            [(m[part], r, u[part], s_[part], d[part])
                             for m, r, u, s_, d in state["rounds"]]))

    projector._bipartite_merge_indices = indices
    for _ in range(traffic["warm_calls"] if ctx.get("warm", True) else 0):
        call(False)
    sync()
    lap("warmup")
    setup_s = time.perf_counter() - t_start
    print(f"[{ctx['workload']}] setup {setup_s:.3f} s = " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + f"; threads {torch.get_num_threads()}",
        file=sys.stderr, flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    state["i"] = 0
    with trace_lib.device_profile(bool(ctx["trace"]) and cuda) as prof:
        spans_window = common.run_window(lambda: call(True, bool(ctx["trace"])),
                                         ctx["seconds"], clock=time.time)
    projector._bipartite_merge_indices = real_indices
    peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    if ctx["trace"] and cuda:
        print(f"[{ctx['workload']}] profiler: start {prof['start_s']:.1f} s, stop "
              f"{prof['stop_s']:.1f} s, read {prof['read_s']:.1f} s, "
              f"{len(prof['events'])} device events", file=sys.stderr, flush=True)
    calls = len(spans_window)
    window_s = spans_window[-1][1] - spans_window[0][0]
    window = (int(spans_window[0][0] * 1e9), int(spans_window[-1][1] * 1e9))
    reduced = (trace_lib.reduce(prof["events"], spans.items, window, kernel=KERNEL)
               if ctx["trace"] and cuda else None)
    t_check = time.perf_counter()
    numbers = compare(kept, vit, vd, frames)
    print(f"[{ctx['workload']}] reference check of {len(checked)} videos: "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr, flush=True)
    ok, checks = common.verdict(numbers, cellx["limits"])
    videos = calls * per_call
    record = {"videos": videos, "calls": calls, "window_s": window_s, "vision": vd,
              "frames_per_clip": traffic["frames_per_clip"], "clips": traffic["clips"],
              "videos_per_call": per_call, "card": ctx["card"], "trace": reduced}
    if ctx["trace"]:
        metrics = {}
        for m in cellx["per_layer"]:
            value = common.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = common.metric(value, m["unit"])
    else:
        metrics = {"extract_videos_per_s": common.metric(videos / window_s, "videos/s"),
                   "setup_s": common.metric(setup_s, "s")}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": ctx["card"]["name"],
                   "count": 1, "memory_peak_bytes": peak_bytes}
    result = {"correct": ok, "attempted": videos, "failed": 0, "metrics": metrics,
              "device": device_info}
    if reduced:
        device_info.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    out = {"result": result, "checks": checks}
    if ctx.get("keep_state"):
        out["state"] = {"vit": vit, "vd": vd, "frames": frames, "checked": checked,
                        "kept": kept}
    return out


def compare(kept: Dict[int, List], vit: Dict, vd: Dict, frames) -> Dict[str, float]:
    """feature_rel_err: the largest relative Frobenius error of a checked
    video's features, over every timed call that returned them, against
    the float32 reference tower merged by that call's own ToMe decisions
    (ToMe's merges hinge on rankings that a rounding reorders: a float32
    ToMe on the program's own tower output lands far from the
    reference's). merge_shortfall: the largest, over the same calls and
    videos, of how far those decisions fall short of ToMe's rule
    (reference/vit.merge_shortfall). A checked video that no call returned
    reads infinite."""
    import torch

    from benchmark.reference import vit as ref

    err = short = 0.0
    with torch.no_grad(), ref.full_fp32():
        for v, calls in kept.items():
            if not calls:
                return {"feature_rel_err": float("inf"), "merge_shortfall": float("inf")}
            tower = ref.towers(vit, vd, frames[v: v + 1])
            for out, rounds in calls:
                err = max(err, ref.relative_error(out, ref.replay(tower, rounds)))
                short = max(short, ref.merge_shortfall(rounds))
    return {"feature_rel_err": err, "merge_shortfall": short}
