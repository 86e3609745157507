#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's
own size: for each seed, one short window of the program (the cell's
driver, without its warm-up) gives the numbers that a run compares, and
the control, the plain reference computed with float8 (e4m3) operands in
every weight product and put in the program's place, gives the same
numbers against the float32 reference. With --fault the program runs
with that fault planted (benchmark/controls/faults.py), for the readings
a limit is held against where the control fails another number.

    python3 benchmark/controls/readings.py --workload NAME --seeds 11,12,13 \
        [--seconds 0] [--no-control] [--chips N] [--fault worst_merges] \
        [--out readings.jsonl]

One JSON line per seed and side: {"workload", "seed", "side": "program" |
"control" | the fault's name, the numbers}. The benchmark's own runs never
run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def control_rerank(state):
    import numpy as np
    import torch

    from benchmark.drivers.rerank import MATRICES, pairs_of
    from benchmark.reference import llm as ref

    s = state
    feats = torch.from_numpy(s["inp"]["features"]).to(s["device"])
    numbers = {}
    with torch.no_grad(), ref.full_fp32():
        for key, (rows, cols) in s["cells"].items():
            kind = MATRICES[key][1]
            pairs = pairs_of(key, rows, cols)
            fn = ref.vtg_scores if kind.startswith("vtg") else ref.tvg_scores
            extra = (s["traffic"]["dataset"],) if kind.startswith("vtg") else ()
            args = (s["params"], s["mdl"], s["inp"]["captions"], feats, pairs) + extra + (
                s["traffic"]["caption_budget"], s["lora"], s["scale"])
            want = fn(*args).cpu().numpy()
            got = fn(*args, quant=ref.fake_fp8).cpu().numpy()
            gap = float(np.max(np.abs(got - want)))
            name = f"{kind.split('_')[0]}_gap"
            numbers[name] = max(numbers.get(name, 0.0), gap)
    return numbers


def control_extract(state):
    """The control judged as the program is: its output against the
    float32 tower merged by its own ToMe decisions, and those decisions
    against ToMe's rule from its own metric."""
    import torch

    from benchmark.reference import vit as ref

    s = state
    err = short = 0.0
    with torch.no_grad(), ref.full_fp32():
        for v in s["checked"]:
            frames = s["frames"][v: v + 1]
            rounds = []
            got = ref.featurize(s["vit"], s["vd"], frames, quant=ref.fake_fp8, record=rounds)
            tower = ref.towers(s["vit"], s["vd"], frames)
            err = max(err, ref.relative_error(got[0], ref.replay(tower, rounds)))
            short = max(short, ref.merge_shortfall(rounds))
    return {"feature_rel_err": err, "merge_shortfall": short}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--chips", type=int, default=None,
                    help="run the program on this many cards instead of the cell's "
                         "(the control's readings do not depend on them)")
    ap.add_argument("--fault", choices=("worst_merges",), default=None)
    args = ap.parse_args()
    import torch

    from benchmark import common

    cellx = common.cell(common.spec(ROOT), args.workload)
    if args.chips:
        cellx["workload"] = dict(cellx["workload"], chips=args.chips)
    if args.fault == "worst_merges":
        from benchmark.controls import faults
        from blim_tpu_torch.models import projector

        projector._bipartite_merge_indices = faults.worst_merges(
            projector._bipartite_merge_indices)
    driver = common.load_driver(cellx["driver"])
    card = common.card(torch)
    lines = []
    for seed in [int(s) for s in args.seeds.split(",")]:
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
            fn = control_extract if cellx["traffic"]["driver"] == "extract" else control_rerank
            lines.append({"workload": args.workload, "seed": seed, "side": "control",
                          **fn(out["state"])})
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
