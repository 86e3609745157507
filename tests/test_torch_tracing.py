"""The port's tracer (utils/profiling.py) and the host-sync counter
(RerankEngine.host_syncs), on the CPU at the tiny config in fp32:

  * spans nest with the right parent and call id, a tracer drains only
    with no span open, and self times subtract exactly what the children
    cover;
  * with no tracer active a span is the shared null context and records
    nothing;
  * a torch.profiler CPU event inside a span falls within the span's
    interval (one clock), and the profiler's trace names the span;
  * a packed evaluation (fine-tuned and zero-shot, CPN on) returns the same
    matrices bit for bit and the same host_syncs with tracing on and off;
  * host_syncs equals the copies and readbacks the run's passes and steps
    make, in the packed and the rectangle schedules;
  * the `timings` marks equal the span boundaries they close, and every
    step's upload, dispatch and readback lies inside its pass.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from blim_tpu_torch.checkpoints.convert import init_params
from blim_tpu_torch.core.config import tiny_model_config
from blim_tpu_torch.data.prompts import make_tvg_layout, make_vtg_layout
from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
from blim_tpu_torch.engine.evaluation import EvalInputs, evaluation
from blim_tpu_torch.engine.rerank import RerankEngine
from blim_tpu_torch.utils import profiling
from blim_tpu_torch.utils.profiling import Span

N, TOPK = 8, 4
CAPTIONS = [
    "a cat sits on a mat",
    "a man rides a horse through a field",
    "children play soccer in the park",
    "a chef cooks pasta in a kitchen",
    "a dog catches a frisbee",
    "two people dance under the lights",
    "a train crosses a long bridge",
    "waves crash against the rocks",
]
PASS_SPANS = {"score_pairs_vtg_packed": "rerank.vtg",
              "compute_vtg_priors_packed": "rerank.vtg_prior",
              "score_pairs_tvg_packed": "rerank.tvg"}
# host_syncs of a pass: (once a pass, a step) — the packed steps copy their
# pack arrays (VTG: video ids, ids, segments, positions, labels; prior: the
# same without video ids; TVG: ids, segments, positions and the query
# segment, caption and video lists) and read their scores back; the
# rectangle copies a step's group ids and reads back its scores (and TVG
# priors); the VTG passes copy the prefix once a pass, the first prior pass
# of an engine its prefix (ids, positions, mask)
SYNCS = {"score_pairs_vtg_packed": (2, 5 + 1), "compute_vtg_priors_packed": (3, 4 + 1),
         "score_pairs_tvg_packed": (0, 6 + 1), "score_pairs_vtg_shared": (2, 2 + 1),
         "compute_vtg_priors": (3, 1 + 1), "score_pairs_tvg_shared": (0, 2 + 2)}
# the banks: the VTG bank's features, rows (3), window labels and suffixes
# (3); the TVG bank's rows (3), prefixes (3) and first ids (the features
# shared)
BANK_SYNCS = {False: 8, True: 8 + 7}


@pytest.fixture(scope="module")
def flow():
    torch.manual_seed(0)
    cfg = tiny_model_config(vocab_size=152064, num_clips=4)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tok = ByteFallbackTokenizer()
    vtg = make_vtg_layout(tok, "MSRVTT", cfg.video_tokens_vtg, max_caption_tokens=48)
    tvg = make_tvg_layout(tok, cfg.num_clips, max_caption_tokens=48)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal(
        (N, cfg.num_clips, cfg.tokens_per_clip, cfg.mm_hidden_size)).astype(np.float32) * 0.5
    inputs = EvalInputs(CAPTIONS, np.arange(N), feats,
                        rng.standard_normal((N, N)).astype(np.float32) + 0.1,
                        rng.standard_normal((N, N)).astype(np.float32) + 0.1)
    return cfg, params, tok, vtg, tvg, inputs


def _evaluate(flow, has_tvg: bool, traced: bool, packed: bool = True):
    """One evaluation on a fresh engine whose passes log the steps they
    ran; the tracer's spans when traced (else None)."""
    cfg, params, tok, vtg, tvg, inputs = flow
    engine = RerankEngine(params, cfg, vtg, tvg if has_tvg else None, device="cpu")
    steps = []
    for name in SYNCS:
        def wrapped(*a, _name=name, _real=getattr(engine, name), **k):
            s0 = engine.steps
            out = _real(*a, **k)
            steps.append((_name, engine.steps - s0))
            return out
        setattr(engine, name, wrapped)
    timings = {}
    tracer = profiling.Tracer()
    with profiling.tracing(tracer) if traced else contextlib.nullcontext():
        t2v, v2t = evaluation(engine, inputs, tok, "MSRVTT", topk=TOPK, cpn=True,
                              has_tvg=has_tvg, verbose=False, timings=timings, packed=packed)
    return {"t2v": t2v, "v2t": v2t}, engine, steps, timings, tracer.drain() if traced else None


@pytest.fixture(scope="module")
def runs(flow):
    return {(has_tvg, traced): _evaluate(flow, has_tvg, traced)
            for has_tvg in (True, False) for traced in (False, True)}


# ---------------------------------------------------------------------------
# the tracer alone
# ---------------------------------------------------------------------------

def test_spans_nest_with_their_parent_and_call():
    with profiling.tracing() as tracer:
        with profiling.span("outside"):
            pass
        for _ in range(2):
            with profiling.span("evaluation", call=True) as root:
                assert root.start_ns > 0
                with profiling.span("rerank.vtg"):
                    with profiling.span("rerank.dispatch"):
                        pass
                    with pytest.raises(RuntimeError):
                        tracer.drain()          # spans still open
                with profiling.span("evaluation.scatter"):
                    pass
            assert profiling.closed_end_ns("evaluation") == tracer.last_closed.end_ns
            assert profiling.closed_end_ns("rerank.vtg") is None
    spans = tracer.drain()
    assert [(s.name, s.parent, s.call) for s in spans] == [
        ("outside", -1, -1),
        ("evaluation", -1, 0), ("rerank.vtg", 1, 0), ("rerank.dispatch", 2, 0),
        ("evaluation.scatter", 1, 0),
        ("evaluation", -1, 1), ("rerank.vtg", 5, 1), ("rerank.dispatch", 6, 1),
        ("evaluation.scatter", 5, 1)]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert tracer.drain() == []


def test_self_times_subtract_what_the_children_cover():
    spans = [Span("evaluation", 0, 100, -1, 0),
             Span("rerank.vtg", 10, 40, 0, 0),
             Span("rerank.upload", 12, 20, 1, 0),
             Span("rerank.upload", 25, 27, 1, 0),
             Span("rerank.vtg", 50, 60, 0, 0),
             Span("evaluation", 200, 250, -1, 1),
             Span("rerank.vtg", 210, 230, 5, 1)]
    assert profiling.self_times(spans) == {
        "evaluation": (100 - 30 - 10) + (50 - 20), "rerank.vtg": (30 - 8 - 2) + 10 + 20,
        "rerank.upload": 8 + 2}
    assert profiling.self_times(spans, call=1) == {"evaluation": 30, "rerank.vtg": 20}
    assert sum(profiling.self_times(spans, call=0).values()) == 100


def test_no_tracer_records_nothing():
    assert profiling._active is None
    first = profiling.span("rerank.dispatch")
    assert first is profiling.span("evaluation", call=True)     # one shared null context
    with first as scope:
        assert scope is None
    assert profiling.closed_end_ns("rerank.dispatch") is None
    with profiling.tracing() as outer:
        with profiling.tracing() as inner:
            with profiling.span("inner"):
                pass
        with profiling.span("outer"):
            pass
    with profiling.span("after"):
        pass
    assert profiling._active is None
    assert [s.name for s in inner.drain()] == ["inner"]
    assert [s.name for s in outer.drain()] == ["outer"]


def test_a_profiler_event_falls_inside_its_span():
    x = torch.ones(128, 128)
    with profiling.tracing() as tracer, profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("blim.mm"):
            (x @ x).sum()
    (sp,) = tracer.drain()
    events = {e.name(): (e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
              if e.name() in ("aten::mm", "blim.mm")}
    mm0, mm1 = events["aten::mm"]
    assert sp.start_ns <= mm0 <= mm1 <= sp.end_ns
    r0, r1 = events["blim.mm"]                  # the span's record_function range
    assert r0 <= sp.start_ns and sp.end_ns <= r1


# ---------------------------------------------------------------------------
# the tracer and the counter in the rerank engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("has_tvg", [True, False], ids=["finetuned", "zeroshot"])
def test_tracing_changes_no_score_and_no_sync(runs, has_tvg):
    off, on = runs[(has_tvg, False)], runs[(has_tvg, True)]
    for direction in ("t2v", "v2t"):
        assert off[0][direction].keys() == on[0][direction].keys()
        for name, mat in off[0][direction].items():
            np.testing.assert_array_equal(mat, on[0][direction][name])
    assert off[1].host_syncs == on[1].host_syncs > 0
    assert off[1].steps == on[1].steps and off[2] == on[2]


def _expected_syncs(steps, has_tvg):
    return BANK_SYNCS[has_tvg] + sum(SYNCS[name][0] + n * SYNCS[name][1] for name, n in steps)


@pytest.mark.parametrize("has_tvg", [True, False], ids=["finetuned", "zeroshot"])
def test_host_syncs_count_the_passes_copies_and_readbacks(runs, has_tvg):
    _, engine, steps, _, _ = runs[(has_tvg, True)]
    assert {name for name, _ in steps} == (set(PASS_SPANS) if has_tvg
                                           else set(PASS_SPANS) - {"score_pairs_tvg_packed"})
    assert sum(n for _, n in steps) == engine.steps
    assert engine.host_syncs == _expected_syncs(steps, has_tvg)


def test_the_rectangle_counts_syncs_and_opens_no_engine_span(flow):
    _, engine, steps, _, spans = _evaluate(flow, True, True, packed=False)
    assert {name for name, _ in steps} == {"score_pairs_vtg_shared", "compute_vtg_priors",
                                           "score_pairs_tvg_shared"}
    assert engine.host_syncs == _expected_syncs(steps, True)
    assert {s.name for s in spans} == {"evaluation", "evaluation.banks", "evaluation.scatter"}


@pytest.mark.parametrize("has_tvg", [True, False], ids=["finetuned", "zeroshot"])
def test_marks_are_the_span_boundaries(runs, has_tvg):
    _, engine, _, timings, spans = runs[(has_tvg, True)]
    (root,) = [s for s in spans if s.name == "evaluation"]
    end = {s.name: s.end_ns for s in spans if s.parent == 0}
    closes = {"upload_tvg" if has_tvg else "upload": "evaluation.banks",
              "prior_done": "rerank.vtg_prior", "vtg_done": "rerank.vtg"}
    if has_tvg:
        closes["tvg_done"] = "rerank.tvg"
    for mark, name in closes.items():
        assert timings[mark] == (end[name] - root.start_ns) / 1e9, mark
    assert set(timings) == set(closes) | {"total"} | ({"upload"} if has_tvg else set())
    # every step's upload and dispatch and every readback sits in a pass span
    passes = {i: s.name for i, s in enumerate(spans) if s.name in PASS_SPANS.values()}
    assert all(spans[s.parent].name == "evaluation" for s in spans if s.parent >= 0
               and s.name.startswith("evaluation."))
    for step_part in ("rerank.upload", "rerank.dispatch", "rerank.readback"):
        parts = [s for s in spans if s.name == step_part]
        assert len(parts) == engine.steps, step_part
        assert all(s.parent in passes for s in parts)
    assert all(s.parent in passes for s in spans if s.name == "rerank.pack")
    assert all(spans[i].parent == 0 for i in passes)
