"""scripts/analyze_schedule_torch.py, the port's schedule analyser, against
scripts/analyze_schedule.py: the same flags print the same report, number
for number (both are host-only FLOP accounting over the same synthetic
workload, so the reports are equal as text)."""

import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scripts():
    return {name: _load(name) for name in ("analyze_schedule", "analyze_schedule_torch")}


def _report(module, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    monkeypatch.setattr(module, "QUIET", False)
    module.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--queries", "64", "--finetuned-queries", "32"],
    ["--queries", "16", "--finetuned-queries", "8", "--sweep"],
], ids=["report", "sweep"])
def test_port_prints_the_jax_analyzers_report(scripts, argv, capsys, monkeypatch):
    want = _report(scripts["analyze_schedule"], argv, capsys, monkeypatch)
    got = _report(scripts["analyze_schedule_torch"], argv, capsys, monkeypatch)
    assert "TOTAL: dispatched" in want or "#### sweep" in want
    assert got == want

