#!/usr/bin/env python3
"""The readings a mixture-of-experts rerank cell's limits are set from, on
the card at the cell's own size (`readings.py` for the `rerank_moe`
driver): for each seed, one short window of the program (the cell's
driver, without its warm-up) gives the numbers a run compares; the
control, the plain reference computed with float8 (e4m3) operands in every
weight product (the router's too) and routed by its own probabilities, is
judged as the program is: its scores against the float32 reference routed
by the control's decisions, and those decisions against the top-P rule on
the float32 reference's probabilities. With --fault top1_only the program
runs with every token routed to its top-1 expert only
(benchmark/controls/faults_moe.py).

With --layers, in place of the readings, the witness of `route_shortfall`'s
size: one call of the seed's inputs with the step graphs set aside, the
program's float32 router probabilities kept beside its logged decisions,
and the reference routed by those decisions over the checked pairs; per
layer, the shortfall, the largest and mean |program p - reference p| over
the pairs' judged tokens, and the largest change of the reference's p when
its router input alone is rounded to bf16; over the whole call, how many
token-layers' logged decisions differ from the top-P rule applied to the
program's own probabilities.

    python3 benchmark/controls/readings_moe.py --workload NAME --seeds 11,12 \
        [--seconds 0] [--no-control] [--fault top1_only] [--layers] \
        [--out readings.jsonl]

One JSON line per seed and side: {"workload", "seed", "side": "program" |
"control" | the fault's name | "layers", the numbers}. The benchmark's own
runs never run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def control(state):
    import numpy as np
    import torch

    from benchmark.drivers.rerank import pairs_of
    from benchmark.reference import llm as ref_llm
    from benchmark.reference import moe_llm as ref

    s = state
    pairs = sorted({p for key, (rows, cols) in s["cells"].items()
                    for p in pairs_of(key, rows, cols)})
    feats = torch.from_numpy(s["inp"]["features"]).to(s["device"])
    args = (s["params"], s["mdl"], s["inp"]["captions"], feats, pairs,
            s["traffic"]["dataset"], s["traffic"]["caption_budget"])
    with torch.no_grad(), ref_llm.full_fp32():
        own = []
        got = ref.vtg_scores(*args, quant=ref_llm.fake_fp8, record=own).cpu().numpy()
        routes = [torch.stack([d for _, d in pair]).to(torch.int8) for pair in own]
        judged = []
        want = ref.vtg_scores(*args, decisions=routes, record=judged).cpu().numpy()
    top_p = s["mdl"]["mlp_dynamic_top_p"]
    return {"vtg_gap": float(np.max(np.abs(got - want))),
            "route_shortfall": max(ref.route_shortfall(p, d, top_p)
                                   for pair in judged for p, d in pair)}


def layer_drift(cellx, seed: int, device) -> dict:
    """The --layers witness on one seed (see the module's docstring)."""
    import numpy as np
    import torch

    from benchmark import common, inputs as inputs_lib, weights_moe
    from benchmark.drivers.rerank import matrices_of, model_dict, pairs_of, sample_cells
    from benchmark.drivers.rerank_moe import pair_routes
    from benchmark.reference import llm as ref_llm
    from benchmark.reference import moe_llm as ref
    from blim_tpu_torch.core.config import from_hf_config_dict
    from blim_tpu_torch.core.numerics import einsum_fp32
    from blim_tpu_torch.data.prompts import make_vtg_layout
    from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
    from blim_tpu_torch.engine import step_graphs
    from blim_tpu_torch.engine.evaluation import EvalInputs, evaluation
    from blim_tpu_torch.engine.rerank import RerankEngine
    from blim_tpu_torch.kernels import flash_attention as fa
    from blim_tpu_torch.models import moe

    traffic, config = cellx["traffic"], cellx["config"]
    cfg, mdl = from_hf_config_dict(config), model_dict(config)
    if device.type == "cuda":
        fa.build(("flash_fwd",))
    dtype = torch.bfloat16 if config["torch_dtype"] == "bfloat16" else torch.float32
    params = weights_moe.llm_tree(mdl, common.sub_seed(seed, 1), dtype, device)
    inp = inputs_lib.rerank_inputs(traffic, mdl, common.sub_seed(seed, 3),
                                   common.sub_seed(seed, 4), device)
    tok = ByteFallbackTokenizer()
    layout = make_vtg_layout(tok, traffic["dataset"], cfg.video_tokens_vtg,
                             max_caption_tokens=traffic["caption_budget"])
    cells = sample_cells(inp, traffic["topk"], matrices_of(False, traffic["cpn"]),
                         traffic["check_cells"], common.sub_seed(seed, 5))
    L, top_p, top_k = cfg.llm.num_hidden_layers, cfg.llm.moe.top_p, cfg.llm.moe.top_k

    # the program's probabilities of every routed layer call inside a
    # routing-log scope, and each scope's [start, end) in that list
    probs, scopes, inside = [], [], []
    real_route, real_collect = moe.route, moe.collect

    def route(x, router, m):
        if inside:
            probs.append(torch.softmax(einsum_fp32("nd,de->ne", x, router), -1))
        return real_route(x, router, m)

    @contextlib.contextmanager
    def collect():
        start = len(probs)
        with real_collect() as log:
            inside.append(True)
            try:
                yield log
            finally:
                inside.pop()
        scopes.append((start, len(probs)))

    engine = RerankEngine(params, cfg, layout, None, device=device)
    moe.route, moe.collect = route, collect
    try:
        with torch.no_grad(), step_graphs.eager():
            evaluation(engine, EvalInputs(captions=inp["captions"],
                                          item_video_idx=inp["item_video_idx"],
                                          features=inp["features"], t2v_iv2=inp["t2v_iv2"],
                                          v2t_iv2=inp["v2t_iv2"]),
                       tok, traffic["dataset"], topk=traffic["topk"], cpn=traffic["cpn"],
                       has_tvg=False, verbose=False)
    finally:
        moe.route, moe.collect = real_route, real_collect
    # the prior prefix's scope, then the steps' in the routing log's order
    P_prior = len(layout.prior_prefix()[0])
    prior = [sc for sc in scopes if sc[1] - sc[0] == L and probs[sc[0]].shape[0] == P_prior]
    steps = [sc for sc in scopes if sc not in prior]
    assert len(prior) == 1 and len(steps) == len(engine.routing_log), (len(prior), len(steps))
    prob_log, mismatches, token_layers = [], 0, 0
    for (start, end), entry in zip(steps, engine.routing_log):
        parts = {}
        for name, first in (("prefix", start), ("suffix", end - L)):
            dec = entry[name]
            if dec is None:
                parts[name] = None
                continue
            g = probs[first].shape[0] // (dec.shape[2])
            n_real = dec.shape[1]
            p = torch.stack([probs[first + i].view(g, dec.shape[2], -1)[:n_real]
                             for i in range(L)])
            rule = ref.top_p_rule(p.reshape(-1, p.shape[-1]), top_p, top_k)
            mismatches += int((rule.view(dec.shape) != dec.long()).any(-1).sum())
            token_layers += dec[..., 0].numel()
            parts[name] = p
        prob_log.append(dict(entry, **parts))
    prior_p = torch.stack([probs[prior[0][0] + i] for i in range(L)])
    pairs = sorted({pr for key, (rows, cols) in cells.items() for pr in pairs_of(key, rows, cols)})
    routes = pair_routes((engine.routing_log, engine.routing_prior_prefix), pairs, layout)
    program_p = pair_routes((prob_log, prior_p), pairs, layout)
    # the reference, routed by the program's decisions; beside each of its
    # layers the change of p from rounding the router input to bf16
    rounding, record = [], []
    real_experts = ref._experts

    def experts(cfg_, w, quant, h, given):
        out = real_experts(cfg_, w, quant, h, given)
        x = ref.rms_norm(h, w["post_scale"], cfg_["rms_norm_eps"])
        judged = given[:, 0] != ref.FREE
        p16 = torch.softmax(x.bfloat16().float() @ w["router"], -1)
        rounding.append(float((p16 - out[1])[judged].abs().max()) if judged.any() else 0.0)
        return out

    feats = torch.from_numpy(inp["features"]).to(device)
    ref._experts = experts
    try:
        with torch.no_grad(), ref_llm.full_fp32():
            ref.vtg_scores(params, mdl, inp["captions"], feats, pairs, traffic["dataset"],
                           traffic["caption_budget"], decisions=routes, record=record)
    finally:
        ref._experts = real_experts
    layers = []
    for i in range(L):
        short, gaps = 0.0, []
        for b in range(len(pairs)):
            p_ref, dec = record[b][i]
            judged = routes[b][i][:, 0] != ref.FREE
            short = max(short, ref.route_shortfall(p_ref, dec, top_p))
            gaps.append((program_p[b][i][judged].float() - p_ref[judged]).abs().flatten())
        gaps = torch.cat(gaps)
        layers.append({"layer": i, "shortfall": short, "p_gap_max": float(gaps.max()),
                       "p_gap_mean": float(gaps.mean()),
                       "bf16_round_max": max(rounding[i * len(pairs): (i + 1) * len(pairs)])})
    return {"pairs": len(pairs), "token_layers": token_layers,
            "rule_mismatches": mismatches, "layers": layers}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", choices=("top1_only",), default=None)
    ap.add_argument("--layers", action="store_true")
    args = ap.parse_args()
    import torch

    from benchmark import common

    cellx = common.cell(common.spec(ROOT), args.workload)
    if args.fault == "top1_only":
        from benchmark.controls import faults_moe
        from blim_tpu_torch.models import moe

        moe.route = faults_moe.top1_only(moe.route)
    driver = common.load_driver(cellx["driver"])
    card = common.card(torch)
    lines = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        if args.layers:
            device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
            lines.append({"workload": args.workload, "seed": seed, "side": "layers",
                          **layer_drift(cellx, seed, device), "card": card})
            print(json.dumps(lines[-1]), flush=True)
            continue
        ctx = {"root": str(ROOT), "workload": args.workload, "seed": seed,
               "seconds": args.seconds, "trace": 0, "t_start": time.perf_counter(),
               "cell": cellx, "card": card, "warm": False, "keep_state": True}
        out = driver.run(ctx)
        prog = {k: c["value"] for k, c in out["checks"].items()}
        lines.append({"workload": args.workload, "seed": seed,
                      "side": args.fault or "program", **prog,
                      "metrics": out["result"]["metrics"], "card": card})
        print(json.dumps(lines[-1]), flush=True)
        if not args.no_control:
            lines.append({"workload": args.workload, "seed": seed, "side": "control",
                          **control(out["state"])})
            print(json.dumps(lines[-1]), flush=True)
        del out
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
