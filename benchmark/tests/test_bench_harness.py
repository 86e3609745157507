"""The harness on the CPU: result lines, files found by name, the
whole-call window, and the import rules."""

import ast
import contextlib
import gc
import io
import json
import shutil
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from benchmark import common
from benchmark.drivers import extract, rerank
from benchmark.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _last_line(out):
    buf = io.StringIO()
    with redirect_stdout(buf):
        common.emit(out["result"], out["checks"])
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("make,driver", [
    (lambda: tiny.rerank_cell(True), rerank), (lambda: tiny.rerank_cell(False), rerank),
    (tiny.extract_cell, extract)], ids=["rerank-ft", "rerank-zs", "extract"])
def test_result_line_keys(make, driver):
    line = _last_line(driver.run(tiny.context(make())))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert set(line) == set(KEYS) | {"checks"}
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, check in line["checks"].items():
        assert check["limit"] is not None and check["value"] <= check["limit"], name


def test_traffic_and_metric_found_by_name(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(common.HERE, base, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = common.spec(common.ROOT)
    traffic = json.loads((base / "traffic" / "msrvtt256-topk16-zs.json").read_text())
    traffic["queries"] = 64
    (base / "traffic" / "msrvtt64-topk16-zs.json").write_text(json.dumps(traffic))
    (base / "metrics" / "queries_seen.test.py").write_text(
        "def read(record):\n    return float(record['queries'] * record['calls'])\n")
    bench["workloads"].append({"name": "vcf-zs-rerank-msrvtt64", "traffic": "msrvtt64-topk16-zs",
                               "config": "videochat-flash-qwen2-7b-res448", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "queries_seen.test", "unit": "queries",
                               "better": "higher", "source": "program_counter",
                               "layer": "evaluation", "moves": "rerank_qps",
                               "workloads": ["vcf-zs-rerank-msrvtt64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cellx = common.cell(common.spec(tmp_path), "vcf-zs-rerank-msrvtt64", base=base)
    assert cellx["traffic"]["queries"] == 64
    assert [m["name"] for m in cellx["per_layer"]] == ["queries_seen.test"]
    read = common.metric_reader("queries_seen.test", base=base)
    assert read({"queries": 64, "calls": 3}) == 192.0
    with pytest.raises(FileNotFoundError):
        common.metric_reader("no_such_metric", base=base)


class FakeClock:
    def __init__(self, durations):
        self.t, self.durations, self.starts = 0.0, list(durations), []

    def __call__(self):
        return self.t

    def call(self):
        self.starts.append(self.t)
        self.t += self.durations.pop(0)


@pytest.mark.parametrize("durations,seconds,expected", [
    ([10.0] * 10, 45.0, 4), ([20.0] * 10, 45.0, 2), ([30.0] * 10, 45.0, 1),
    ([50.0] * 10, 0.0, 1), ([10.0, 30.0, 10.0, 10.0], 45.0, 2)])
def test_window_whole_calls(durations, seconds, expected):
    clock = FakeClock(durations)
    spans = common.run_window(clock.call, seconds, clock=clock)
    assert len(spans) == expected
    for i in range(1, len(spans)):
        mean = (spans[i - 1][1] - spans[0][0]) / i
        assert spans[i - 1][1] - spans[0][0] + mean <= seconds
    assert [s for s, _ in spans] == clock.starts


def test_window_stops_where_rank_zero_says():
    clock = FakeClock([1.0] * 10)
    votes = iter([True, True, False])
    spans = common.run_window(clock.call, 100.0, agree=lambda go: next(votes), clock=clock)
    assert len(spans) == 2


def test_window_keeps_the_collector_out():
    seen = []
    common.run_window(lambda: seen.append(gc.isenabled()), 0.0)
    assert seen == [False] and gc.isenabled() and gc.get_freeze_count() == 0


def test_traced_rerank_run_reads_walls_from_the_untraced_window(monkeypatch):
    """--trace 1: the window runs untraced, then one more call under the
    profiler; the pass walls come from the window."""
    from blim_tpu_torch.engine import evaluation as ev

    from benchmark import trace as trace_lib

    profiled, under = [], [False]
    real_eval, real_profile = ev.evaluation, trace_lib.device_profile

    def counted(*args, **kwargs):
        profiled.append(under[0])
        return real_eval(*args, **kwargs)

    @contextlib.contextmanager
    def profile(enabled):
        under[0] = True
        with real_profile(enabled) as holder:
            yield holder
        under[0] = False

    monkeypatch.setattr(ev, "evaluation", counted)
    monkeypatch.setattr(trace_lib, "device_profile", profile)
    cellx = tiny.rerank_cell(True)
    cellx["per_layer"] = [{"name": "vtg_pass_ms_per_query", "unit": "ms/query"}]
    out = rerank.run(tiny.context(cellx, seconds=0.0, trace=1))
    assert profiled == [False, False, True]      # warm-up, the window's one call, the traced one
    assert out["result"]["attempted"] == 2 * cellx["traffic"]["queries"]
    assert out["result"]["correct"] and "vtg_pass_ms_per_query" in out["result"]["metrics"]


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_in_the_benchmark_and_no_program_in_the_reference():
    for path in common.HERE.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "blim_tpu"}, path
    for path in (common.HERE / "reference").glob("*.py"):
        assert "blim_tpu_torch" not in _imports(path), path


def test_forbidden_modules_compare_whole_names():
    assert common.forbidden_modules(["blim_tpu_torch.models.qwen2", "numpy"]) == []
    assert common.forbidden_modules(["blim_tpu.models", "jax.numpy", "jaxlib"]) == [
        "blim_tpu", "jax", "jaxlib"]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import common\n"
            "from benchmark.drivers import rerank\n"
            "from benchmark.tests import tiny\n"
            "rerank.run(tiny.context(tiny.rerank_cell(True)))\n"
            "print(common.forbidden_modules())\n") % str(common.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(Path.home())})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_cards():
    out = subprocess.run([sys.executable, str(common.HERE / "run.py"), "--workload",
                          "blim-ft-rerank-msrvtt256", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=120, cwd=common.ROOT,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    shutil.copytree(common.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "blim-ft-rerank-msrvtt256", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=120, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
