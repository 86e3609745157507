"""The mixture-of-experts rerank cell on the CPU at a tiny size: its result
line, its limits file, the planted top-1 fault and the float8 control, the
per-layer drift witness, and how device time is put under the layer's
spans; on a card, the traced line at a tiny size."""

import io
import json
import time
from contextlib import redirect_stdout

import numpy as np
import pytest

from benchmark import common
from benchmark.controls import faults_moe, readings_moe
from benchmark.drivers import rerank_moe

CELL = "unimoe2-zs-rerank-msrvtt256"
TINY_LIMIT = 1e-3


def tiny_cell(trace_metrics=()):
    bench = common.spec(common.ROOT)
    cellx = common.cell(bench, CELL)
    cellx["config"].update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, dynamic_intermediate_size=32,
                           shared_intermediate_size=16, mm_hidden_size=32,
                           torch_dtype="float32")
    cellx["traffic"].update(queries=8, topk=2, check_cells=3)
    cellx["limits"]["vtg_gap"] = {"limit": TINY_LIMIT}
    cellx["per_layer"] = [m for m in cellx["per_layer"] if m["name"] in trace_metrics]
    return cellx


def context(cellx, trace=0, **kw):
    return dict({"root": str(common.ROOT), "workload": "tiny", "seed": 2**31 + 5,
                 "seconds": 0.0, "trace": trace, "t_start": time.perf_counter(),
                 "cell": cellx, "card": {"name": "cpu", "power_limit": None},
                 "device": "cpu"}, **kw)


def test_result_line():
    out = rerank_moe.run(context(tiny_cell()))
    buf = io.StringIO()
    with redirect_stdout(buf):
        common.emit(out["result"], out["checks"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] == 8
    assert set(line["metrics"]) == {"rerank_qps", "setup_s"}
    assert set(line["checks"]) == {"vtg_gap", "route_shortfall", "fill_errors"}


def test_traced_line_reports_the_counter_and_leaves_device_metrics_out():
    names = ("moe_experts_per_token", "moe_expert_roofline", "moe_dispatch_share",
             "rerank_steps_per_query", "rerank_useful_share")
    out = rerank_moe.run(context(tiny_cell(names), trace=1))
    metrics = out["result"]["metrics"]
    assert set(metrics) == {"moe_experts_per_token", "rerank_steps_per_query",
                            "rerank_useful_share"}
    assert 0.0 < metrics["moe_experts_per_token"]["value"] <= 2.0


def test_limits_file_keys():
    limits = common.load_json(common.HERE / "limits" / f"{CELL}.json")
    assert set(limits) == {"vtg_gap", "route_shortfall", "fill_errors"}
    for name in ("vtg_gap", "route_shortfall"):
        lim = limits[name]
        assert set(lim) == {"limit", "lower", "upper", "read"}
        assert lim["lower"] < lim["limit"] < lim["upper"]
    assert limits["fill_errors"]["limit"] == 0


def test_fault_and_control_fail_where_the_program_passes(monkeypatch):
    from blim_tpu_torch.models import moe

    cellx = tiny_cell()
    out = rerank_moe.run(context(cellx, keep_state=True))
    assert out["result"]["correct"]
    control = readings_moe.control(out["state"])
    assert control["vtg_gap"] > 10 * out["checks"]["vtg_gap"]["value"]
    monkeypatch.setattr(moe, "route", faults_moe.top1_only(moe.route))
    faulty = rerank_moe.run(context(tiny_cell()))
    assert not faulty["result"]["correct"]
    assert faulty["checks"]["route_shortfall"]["value"] > cellx["limits"]["route_shortfall"]["limit"]


def test_a_program_without_the_mixture_of_experts_fails_at_once(monkeypatch):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith(".moe") else real(name, *a))
    with pytest.raises(RuntimeError, match="mixture-of-experts"):
        rerank_moe.run(context(tiny_cell()))


def test_device_time_goes_to_the_span_its_launch_started_in():
    names = rerank_moe.MOE_SPANS
    spans = [(300, 400, "moe.experts"), (100, 200, "moe.route")]
    rows = [  # (on_device, start, end, correlation id)
        (False, 110, 115, 1),           # runtime calls: launches inside moe.route
        (False, 150, 152, 2),
        (False, 310, 312, 3),           # inside moe.experts
        (False, 450, 452, 4),           # in no span
        (True, 1000, 1500, 1),
        (True, 1500, 1600, 2),
        (True, 1600, 3600, 3),
        (True, 3600, 3700, 4),
        (True, 3900, 4000, 99),         # no runtime call seen
    ]
    got = rerank_moe.span_device_seconds(spans, rows, names)
    assert got["moe.route"] == pytest.approx(600e-9)
    assert got["moe.experts"] == pytest.approx(2000e-9)
    assert got["moe.permute"] == got["moe.shared"] == got["moe.combine"] == 0.0
    assert got["total"] == pytest.approx(2800e-9)


def test_an_eager_call_opens_every_span_of_the_layer_apart():
    """The host side of the reading on the CPU: inside step_graphs.eager()
    with the tracer on, each MoE layer of each forward opens the five spans,
    none inside another."""
    from blim_tpu_torch.checkpoints import convert
    from blim_tpu_torch.data.prompts import make_vtg_layout
    from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
    from blim_tpu_torch.engine import step_graphs
    from blim_tpu_torch.engine.rerank import CaptionBank, RerankEngine
    from blim_tpu_torch.utils import profiling
    from tests.test_torch_moe import tiny_moe_config

    cfg = tiny_moe_config(1)
    params = convert.init_params(cfg, seed=1, device="cpu")
    tok = ByteFallbackTokenizer()
    layout = make_vtg_layout(tok, "MSRVTT", cfg.video_tokens_vtg, max_caption_tokens=24)
    engine = RerankEngine(params, cfg, layout, device="cpu")
    feats = np.zeros((1, cfg.num_clips, cfg.tokens_per_clip, cfg.mm_hidden_size), np.float32)
    banks = engine.upload(CaptionBank.build_vtg(["a cat", "dogs run"], tok, "MSRVTT", layout),
                          feats)
    with step_graphs.eager(), profiling.tracing() as tracer:
        engine.score_pairs_vtg_packed(banks, np.array([0, 1]), np.array([0, 0]))
    spans = [sp for sp in tracer.drain() if sp.name in rerank_moe.MOE_SPANS]
    assert len(spans) == 5 * engine.steps * 2      # a layer, prefix and suffix forwards
    assert [sp.name for sp in spans[:5]] == list(rerank_moe.MOE_SPANS)
    ends = [sp.end_ns for sp in spans]
    assert all(b.start_ns >= a for a, b in zip(ends, spans[1:]))


def test_layer_drift_witness_at_the_tiny_size():
    """Float32 on both sides: the program's probabilities, laid out by the
    routing log, are the reference's, and every logged decision is the rule
    on them."""
    import torch

    out = readings_moe.layer_drift(tiny_cell(), 2**31 + 5, torch.device("cpu"))
    assert out["rule_mismatches"] == 0 and out["token_layers"] > 0 and out["pairs"] > 0
    assert [row["layer"] for row in out["layers"]] == [0, 1]
    for row in out["layers"]:
        assert row["p_gap_max"] < 1e-5 and row["shortfall"] < 1e-5
        assert 0.0 < row["bf16_round_max"] < 0.05


@pytest.mark.cuda
def test_traced_tiny_cell_on_the_card_reports_the_layer_metrics():
    """On a card at a tiny bf16 size (head dim 128 for B1): the traced line
    reports the expert roofline and the dispatch share, read from the
    replayed call's kernels and the eager call's spans."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    names = ("moe_experts_per_token", "moe_expert_roofline", "moe_dispatch_share")
    cellx = tiny_cell(names)
    cellx["config"].update(hidden_size=256, num_attention_heads=2, num_key_value_heads=1,
                           dynamic_intermediate_size=128, shared_intermediate_size=64,
                           torch_dtype="bfloat16")
    cellx["limits"]["vtg_gap"] = {"limit": 1.0}
    out = rerank_moe.run(context(cellx, trace=1, device="cuda", card=common.card(torch)))
    metrics = {k: v["value"] for k, v in out["result"]["metrics"].items()}
    assert set(metrics) == set(names), metrics
    assert 0.0 < metrics["moe_dispatch_share"] < 100.0
    assert 0.0 < metrics["moe_expert_roofline"] <= 105.0
