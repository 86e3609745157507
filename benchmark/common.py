"""What every cell of the benchmark shares: the spec in BENCHMARK.json, the
files found by name (configurations, traffic mixes, drivers, per-layer
metric readers, limits), the card's identity and peaks, seeds, the
whole-call window, the correctness verdict and the result line.

A configuration, a traffic mix, a driver kind, a per-layer metric and a
cell's limits are each a file of their own under benchmark/, found by the
name BENCHMARK.json gives them; adding one is adding a file.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Dense peaks of one card, from NVIDIA's H100 SXM data sheet (no sparsity),
# at its 700 W limit: bf16 tensor-core FLOP/s and HBM3 bytes/s.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}}
# Modules that may not be loaded in the process that prints a result,
# compared by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "blim_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def named_file(kind: str, name: str, suffix: str, base: Path = HERE) -> Path:
    """benchmark/<kind>/<name><suffix>; raises naming the missing file."""
    path = base / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no file {path} for {name!r}")
    return path


def load_module(path: Path):
    """Import a Python file by path (names may hold dots)."""
    mod_name = "benchmark_" + path.parent.name + "_" + path.stem.replace(".", "_").replace("-", "_")
    spec_ = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


def load_driver(path: Path):
    """A driver module, imported as benchmark.drivers.<name> so that the
    processes it spawns can import it too."""
    return importlib.import_module(f"benchmark.drivers.{path.stem}")


def cell(bench: Dict, workload: str, base: Path = HERE) -> Dict:
    """Everything a run of one cell reads: its workload entry, configuration
    and traffic files, driver, limits, and the metrics it reports."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(base.parent / conf["file"])
    traffic = load_json(named_file("traffic", wl["traffic"], ".json", base))
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    limits_path = base / "limits" / f"{workload}.json"
    return {"workload": wl, "config": config, "traffic": traffic, "end_to_end": e2e,
            "per_layer": per_layer,
            "limits": load_json(limits_path) if limits_path.is_file() else {},
            "driver": named_file("drivers", traffic["driver"], ".py", base)}


def metric_reader(name: str, base: Path = HERE) -> Callable[[Dict], Optional[float]]:
    """benchmark/metrics/<name>.py's read(record) -> value or None."""
    return load_module(named_file("metrics", name, ".py", base)).read


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one random stream of a run, from --seed."""
    return int(np.random.SeedSequence([int(seed) % 2**64, stream]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def card(torch, index: int = 0) -> Dict:
    """Name and, from nvidia-smi where it answers, the power limit."""
    import subprocess

    name = torch.cuda.get_device_name(index)
    limit = None
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip()
        limit = out or None
    except (OSError, subprocess.SubprocessError):
        pass
    return {"name": name, "power_limit": limit}


def peak(kind: str, name: str) -> float:
    if name not in PEAKS:
        raise KeyError(f"no peak for {name!r} in benchmark/common.PEAKS")
    return PEAKS[name][kind]


def run_window(call: Callable[[], None], seconds: float,
               agree: Callable[[bool], bool] = lambda go: go,
               clock: Callable[[], float] = time.perf_counter) -> List[Tuple[float, float]]:
    """Calls `call` back to back and returns each call's (start, end). A
    call starts only while its predicted end (the mean call so far after
    the last one's end) is inside `seconds` from the first call's start;
    the first call always runs. `agree` lets ranks share one decision.
    Python's collector is kept out of the window: what set-up made is
    collected and frozen before it, and no collection runs inside it."""
    spans: List[Tuple[float, float]] = []
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        while True:
            go = True
            if spans:
                mean = (spans[-1][1] - spans[0][0]) / len(spans)
                go = spans[-1][1] - spans[0][0] + mean <= seconds
            if not agree(go):
                break
            start = clock()
            call()
            spans.append((start, clock()))
    finally:
        gc.enable()
        gc.unfreeze()
    return spans


def forbidden_modules(modules=None) -> List[str]:
    names = sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)})
    return [m for m in names if m in FORBIDDEN]


def verdict(numbers: Dict[str, float], limits: Dict[str, Dict]) -> Tuple[bool, Dict]:
    """Each compared number beside its limit; correct when every number
    is finite and at or under its limit, and every limited number was
    read."""
    checks = {}
    ok = True
    for name, lim in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= lim["limit"]
        checks[name] = {"value": value, "limit": lim["limit"]}
        ok = ok and good
    for name, value in numbers.items():
        if name not in limits:
            checks[name] = {"value": value, "limit": None}
    return ok and bool(limits), checks


def emit(result: Dict, checks: Dict) -> None:
    """The compared numbers as the last lines on standard error, then the
    result line, whose last key holds them, as the last line of standard
    output."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = checks
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()


def metric(value: float, unit: str) -> Dict:
    return {"value": float(value), "unit": unit}
