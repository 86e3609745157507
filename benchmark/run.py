#!/usr/bin/env python3
"""Benchmark of blim_tpu_torch, the PyTorch/CUDA port, on NVIDIA GPUs.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

runs one cell of BENCHMARK.json from the root of a checkout: its driver
(benchmark/drivers/<traffic's driver>.py) sets up the program from the
seed, measures whole calls for S seconds, and checks what those calls
returned against the plain reference. The last line of standard output is
one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), device (and
with --trace 1 the breakdown), then the compared numbers beside their
limits under "checks"; the same numbers end standard error. It exits
non-zero and prints no result without enough CUDA cards, or if a module
of the JAX package or JAX itself was loaded.
"""

import os
import sys
import time

T_START = time.perf_counter()
# Few host threads, fixed before torch and numpy load their pools.
THREADS = "4"
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = THREADS
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import argparse  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# kernel caches of libraries that compile at run time stay in the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "benchmark" / ".cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "benchmark" / ".cache" / "torch_ext"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import common

    bench = common.spec(ROOT)
    cellx = common.cell(bench, args.workload)
    chips = cellx["workload"]["chips"]
    import torch

    torch.set_num_threads(int(THREADS))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = {"root": str(ROOT), "workload": args.workload, "seed": args.seed,
           "seconds": args.seconds, "trace": args.trace, "t_start": T_START, "cell": cellx,
           "card": common.card(torch)}
    print(f"[{args.workload}] {ctx['card']['name']}, power limit {ctx['card']['power_limit']}, "
          f"{chips} card(s), host threads {THREADS}; {time.perf_counter() - T_START:.3f} s "
          f"from start to the cell's set-up (interpreter, torch import, card query)",
          file=sys.stderr, flush=True)
    out = common.load_driver(cellx["driver"]).run(ctx)
    found = common.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    common.emit(out["result"], out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
