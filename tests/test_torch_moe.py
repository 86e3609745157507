"""The port's mixture of experts (Uni-MoE-2.0-Omni's language model,
blim_tpu_torch/models/moe.py) on the CPU: the top-P rule on hand-built
probability rows, the layer against the plain float32 reference
(benchmark/reference/moe_llm.py) on the same decisions, the rerank engine's
packed path and its routing counters against the reference at a tiny size,
the planted top-1 fault read as a route shortfall, dense configurations
unchanged, and the train step's refusal."""

import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import common
from benchmark.controls import faults_moe
from benchmark.drivers import rerank_moe
from benchmark.reference import moe_llm as ref
from blim_tpu_torch.checkpoints import convert
from blim_tpu_torch.core.config import (MoEConfig, Qwen2Config, Qwen2MoEConfig,
                                        from_hf_config_dict, moe_of, tiny_model_config)
from blim_tpu_torch.models import moe, qwen2
from blim_tpu_torch.utils import flops as flops_lib
from blim_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
CONFIG = "uni-moe-2.0-omni-llm-umt-res448"
CELL = "unimoe2-zs-rerank-msrvtt256"
MOE = MoEConfig(routed=4, null=1, shared=2, routed_size=32, shared_size=16)
# float32 on both sides, the same routes: rounding only (~1e-6)
TINY_TOL = 1e-4


def tiny_moe_config(layers: int = 2):
    cfg = tiny_model_config(vocab_size=152064)
    dense = {f.name: getattr(cfg.llm, f.name) for f in dataclasses.fields(Qwen2Config)}
    return dataclasses.replace(
        cfg, llm=Qwen2MoEConfig(**dict(dense, num_hidden_layers=layers), moe=MOE))


def ref_cfg(cfg):
    m = cfg.llm.moe
    return {"mlp_dynamic_expert_num": m.routed, "mlp_dynamic_null_expert_num": m.null,
            "mlp_dynamic_top_p": m.top_p, "mlp_dynamic_top_k": m.top_k,
            "mlp_fixed_expert_num": m.shared, "shared_intermediate_size": m.shared_size,
            "rms_norm_eps": cfg.llm.rms_norm_eps}


def decide(probs):
    """moe.route on rows whose softmax is `probs` (identity router)."""
    x = torch.log(torch.as_tensor(probs, dtype=torch.float32))
    p, e, taken = moe.route(x, torch.eye(x.shape[1]), MoEConfig())
    return moe.decisions(e, taken).tolist(), (taken & (e < 4)).sum(1).tolist()


@pytest.mark.parametrize("probs,want,computing", [
    ([0.75, 0.1, 0.05, 0.05, 0.05], [0, -1], 1),        # one expert reaches 0.7
    ([0.5, 0.3, 0.1, 0.05, 0.05], [0, 1], 2),           # two below it
    ([0.4, 0.25, 0.15, 0.1, 0.1], [0, 1], 2),           # the cap: 0.65 < 0.7, still two
    ([0.05, 0.05, 0.05, 0.05, 0.8], [4, -1], 0),        # the null expert alone: no work
    ([0.1, 0.3, 0.1, 0.1, 0.4], [4, 1], 1),             # null first, then a routed one
    ([0.3, 0.3, 0.2, 0.1, 0.1], [0, 1], 2),             # a tie: the lower index first
    ([0.1, 0.3, 0.1, 0.3, 0.2], [1, 3], 2),
], ids=["one", "two", "cap", "null", "null-first", "tie", "tie-late"])
def test_top_p_rule_on_hand_built_rows(probs, want, computing):
    got, n = decide([probs])
    assert got == [want] and n == [computing]
    assert ref.top_p_rule(torch.tensor([probs]), 0.7, 2).tolist() == [want]


def test_route_and_the_reference_rule_agree_on_random_rows():
    gen = torch.Generator().manual_seed(0)
    probs = torch.softmax(torch.randn(2000, 5, generator=gen) * 2.0, -1)
    got, _ = decide(probs)
    assert got == ref.top_p_rule(probs, 0.7, 2).tolist()


def test_permute_orders_slots_by_expert_stably():
    gen = torch.Generator().manual_seed(1)
    e = torch.randint(0, 5, (37, 2), generator=gen)
    runs = (torch.rand(37, 2, generator=gen) < 0.7) & (e < 4)
    src, dst, ends = moe.permute(e, runs, 4)
    flat = torch.where(runs, e, 4).reshape(-1)
    assert torch.equal(src, torch.argsort(flat, stable=True))
    assert torch.equal(dst[src], torch.arange(74))
    assert ends.tolist() == torch.bincount(flat, minlength=5)[:4].cumsum(0).tolist()


def test_layer_matches_the_reference_on_the_same_decisions():
    cfg = tiny_moe_config(1)
    params = convert.init_params(cfg, seed=3, device="cpu")
    llm = params["llm"]
    llm["layers"]["moe"]["router"]["kernel"].mul_(20.0)     # spread p: one, two and null
    lp = qwen2._layer_slice(llm["layers"], 0)
    h = torch.randn(48, 64, generator=torch.Generator().manual_seed(2))
    with moe.collect() as log, profiling.tracing() as tracer:
        got = qwen2._mlp(cfg.llm, lp, h)
    # every part of the layer runs under its span, one after another
    assert [(sp.name, sp.parent) for sp in tracer.drain()] == [
        (f"moe.{n}", -1) for n in ("route", "permute", "experts", "shared", "combine")]
    dec = log[0]
    assert {int(n) for n in ((dec >= 0) & (dec < 4)).sum(1)} == {0, 1, 2}
    with torch.no_grad():
        w = ref._layer_weights(llm, 0, None)
        want, p, used = ref._experts(ref_cfg(cfg), w, None, h, dec.long())
    assert torch.equal(used, dec.long())
    assert ref.route_shortfall(p, dec, 0.7) < 1e-6
    assert float((got - want).abs().max()) < TINY_TOL


def tiny_cell():
    config = common.load_json(common.HERE / "configs" / f"{CONFIG}.json")
    config.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, dynamic_intermediate_size=32,
                  shared_intermediate_size=16, mm_hidden_size=32, torch_dtype="float32")
    traffic = common.load_json(common.HERE / "traffic" / "msrvtt256-topk16-zs-moe.json")
    traffic.update(queries=8, topk=2, check_cells=3)
    limits = common.load_json(common.HERE / "limits" / f"{CELL}.json")
    limits["vtg_gap"] = {"limit": TINY_TOL}
    return {"workload": {"name": "tiny", "chips": 1}, "config": config, "traffic": traffic,
            "limits": limits, "per_layer": [], "end_to_end": []}


def tiny_context(**kw):
    return dict({"root": str(common.ROOT), "workload": "tiny", "seed": 2**31 + 11,
                 "seconds": 0.0, "trace": 0, "t_start": time.perf_counter(),
                 "cell": tiny_cell(), "card": {"name": "cpu", "power_limit": None},
                 "device": "cpu", "warm": False}, **kw)


def test_engine_packed_path_matches_the_reference(monkeypatch):
    """VTG scores and CPN priors of RerankEngine's packed path against the
    reference routed by the logged decisions; every decision the rule on the
    port's own float32 probabilities."""
    seen = []
    real = moe.route

    def spy(x, router, m):
        p, e, taken = real(x, router, m)
        seen.append((torch.softmax(x.float() @ router.float(), -1), moe.decisions(e, taken)))
        return p, e, taken

    monkeypatch.setattr(moe, "route", spy)
    out = rerank_moe.run(tiny_context())
    checks = out["checks"]
    assert out["result"]["correct"], checks
    assert checks["vtg_gap"]["value"] < TINY_TOL and checks["fill_errors"]["value"] == 0
    assert checks["route_shortfall"]["value"] < 1e-6
    assert len(seen) > 2
    for probs, dec in seen:
        assert torch.equal(dec.long(), ref.top_p_rule(probs, 0.7, 2))


def test_routing_counters_and_flops():
    """The counters' real tokens are the request's (each video's prefix
    once, every pair's suffix, the prior prefix, every caption's suffix),
    and the routed work enters flops and useful_flops through them."""
    from blim_tpu_torch.data.prompts import make_vtg_layout
    from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
    from blim_tpu_torch.engine.rerank import CaptionBank, RerankEngine

    cfg = tiny_moe_config()
    params = convert.init_params(cfg, seed=5, device="cpu")
    tok = ByteFallbackTokenizer()
    layout = make_vtg_layout(tok, "MSRVTT", cfg.video_tokens_vtg, max_caption_tokens=24)
    caps = ["a cat on a mat", "dogs run", "a red car in the street at night", "x y"]
    bank = CaptionBank.build_vtg(caps, tok, "MSRVTT", layout)
    feats = np.random.default_rng(0).standard_normal(
        (3, cfg.num_clips, cfg.tokens_per_clip, cfg.mm_hidden_size)).astype(np.float32)
    engine = RerankEngine(params, cfg, layout, device="cpu")
    banks = engine.upload(bank, feats)
    cap_idx, vid_idx = np.array([0, 1, 2, 3, 1, 2]), np.array([0, 0, 1, 1, 2, 2])
    engine.score_pairs_vtg_packed(banks, cap_idx, vid_idx)
    lens = banks["suffix_len_host"]
    L, P = cfg.llm.num_hidden_layers, layout.prefix_len
    assert engine.moe_tokens.tolist() == [3 * P + int(lens[cap_idx].sum())] * L
    assert engine.moe_tokens_other.sum() > 0            # the packs' padding
    rows = engine.moe_rows[:, :4].sum()
    useful = (engine._useful_vtg(banks, cap_idx, vid_idx)
              + flops_lib.routed_flops(cfg.llm, rows, engine.moe_tokens.sum()))
    assert math.isclose(engine.useful_flops, useful, rel_tol=1e-12)
    every_rows = rows + engine.moe_rows_other[:, :4].sum()
    every_tokens = engine.moe_tokens.sum() + engine.moe_tokens_other.sum()
    assert engine.flops > flops_lib.routed_flops(cfg.llm, every_rows, every_tokens)
    engine.compute_vtg_priors_packed(banks)
    P2 = len(layout.prior_prefix()[0])
    assert engine.moe_tokens[0] == 3 * P + int(lens[cap_idx].sum()) + P2 + int(lens.sum())
    # a routing log entry a step, the prior prefix's apart; close() drops them
    assert len(engine.routing_log) == engine.steps
    assert tuple(engine.routing_prior_prefix.shape) == (L, P2, MOE.top_k)
    engine.close()
    assert not hasattr(engine, "routing_log") and not hasattr(engine, "routing_prior_prefix")


def test_planted_top1_fault_reads_a_shortfall_over_the_limit(monkeypatch):
    monkeypatch.setattr(moe, "route", faults_moe.top1_only(moe.route))
    out = rerank_moe.run(tiny_context())
    limit = common.load_json(common.HERE / "limits" / f"{CELL}.json")["route_shortfall"]["limit"]
    assert out["checks"]["route_shortfall"]["value"] > limit
    assert not out["result"]["correct"]


def test_dense_configs_are_unchanged():
    cfg = tiny_model_config()
    assert type(from_hf_config_dict({}).llm) is Qwen2Config
    assert moe_of(cfg.llm) is None and flops_lib.dense_view(cfg.llm) is cfg.llm
    params = convert.init_params(cfg, seed=0, device="cpu")
    layers = params["llm"]["layers"]
    assert "moe" not in layers and {"gate_proj", "up_proj", "down_proj"} <= set(layers)
    lp = qwen2._layer_slice(layers, 0)
    h = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(0))
    with moe.collect() as log:
        got = qwen2._mlp(cfg.llm, lp, h)
    x = qwen2.rms_norm(h, lp["post_attention_layernorm"]["scale"], cfg.llm.rms_norm_eps)
    want = h + (torch.nn.functional.silu(x @ lp["gate_proj"]["kernel"])
                * (x @ lp["up_proj"]["kernel"])) @ lp["down_proj"]["kernel"]
    assert torch.equal(got, want) and log == []


def test_config_file_reads_as_a_mixture_of_experts():
    d = json.loads((REPO / "benchmark" / "configs" / f"{CONFIG}.json").read_text())
    llm = from_hf_config_dict(d).llm
    assert isinstance(llm, Qwen2MoEConfig)
    assert llm.moe == MoEConfig(routed=4, null=1, shared=2, routed_size=18944,
                                shared_size=2368, top_p=0.7, top_k=2)
    assert (llm.hidden_size, llm.num_hidden_layers, llm.num_attention_heads,
            llm.num_key_value_heads, llm.head_dim) == (3584, 28, 28, 4, 128)
    with pytest.raises(ValueError, match="token_drop"):
        from_hf_config_dict(dict(d, token_drop=True))
    with pytest.raises(ValueError, match="fp32_gate"):
        from_hf_config_dict(dict(d, fp32_gate=False))


def test_train_step_refuses_a_mixture_of_experts():
    from blim_tpu_torch.data.prompts import make_tvg_layout, make_vtg_layout
    from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
    from blim_tpu_torch.engine.train import TrainConfig, make_train_step

    cfg = tiny_moe_config()
    tok = ByteFallbackTokenizer()
    with pytest.raises(NotImplementedError, match="Qwen2MoEConfig"):
        make_train_step(cfg, TrainConfig(), make_vtg_layout(tok, "MSRVTT", cfg.video_tokens_vtg),
                        make_tvg_layout(tok, cfg.num_clips, 24), device="cpu")


class TupleStandInGraph:
    """torch.cuda.CUDAGraph's stand-in on the CPU for steps whose output is
    a tuple: capture runs the closure once and keeps it; a replay runs it
    again into the captured outputs, with the engine counters it moved put
    back (a replayed graph runs no Python)."""

    engines: list = []

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        from blim_tpu_torch.engine import step_graphs

        saved = [{n: getattr(e, n) for n in step_graphs.ENGINE_COUNTERS} for e in self.engines]
        out = self.fn()
        for e, counts in zip(self.engines, saved):
            for n, v in counts.items():
                setattr(e, n, v)
        for a, b in zip(self.out, out):
            a.copy_(b)


def test_graph_path_replays_the_eager_routes(monkeypatch):
    """Through (stand-in) step graphs, captured cold and replayed warm, the
    MoE steps return the eager matrices, routing counters, FLOPs and logged
    decisions bit for bit; inside step_graphs.eager() the steps run eagerly
    beside the graphs kept."""
    from blim_tpu_torch.data.prompts import make_vtg_layout
    from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
    from blim_tpu_torch.engine import step_graphs
    from blim_tpu_torch.engine.evaluation import EvalInputs, evaluation
    from blim_tpu_torch.engine.rerank import RerankEngine

    cfg = tiny_moe_config()
    params = convert.init_params(cfg, seed=7, device="cpu")
    tok = ByteFallbackTokenizer()
    layout = make_vtg_layout(tok, "MSRVTT", cfg.video_tokens_vtg, max_caption_tokens=24)
    rng = np.random.default_rng(1)
    n = 6
    caps = ["a cat on a mat", "dogs run", "a red car at night", "x y", "people dance", "a boat"]
    inputs = EvalInputs(caps, np.arange(n), rng.standard_normal(
        (n, cfg.num_clips, cfg.tokens_per_clip, cfg.mm_hidden_size)).astype(np.float32),
        rng.standard_normal((n, n)).astype(np.float32),
        rng.standard_normal((n, n)).astype(np.float32))

    def run():
        engine = RerankEngine(params, cfg, layout, device="cpu")
        TupleStandInGraph.engines.append(engine)
        t2v, v2t = evaluation(engine, inputs, tok, "MSRVTT", topk=3, cpn=True, has_tvg=False,
                              verbose=False)
        decs = [d for e in engine.routing_log for d in (e["prefix"], e["suffix"]) if d is not None]
        return (t2v, v2t, engine.moe_rows.copy(), engine.moe_tokens_other.copy(), engine.flops,
                engine.useful_flops, decs, engine.graph_captures, engine.graph_replays)

    eager = run()
    monkeypatch.setattr(step_graphs, "graph_maker", lambda device: TupleStandInGraph)
    step_graphs.drop(params)
    cold, warm = run(), run()
    with step_graphs.eager():       # the graphs kept are set aside, not used
        aside = run()
    assert eager[-2:] == (0, 0) and cold[-2] > 0 and warm[-2] == 0
    assert warm[-1] == cold[-2] + cold[-1] and aside[-2:] == (0, 0)
    assert step_graphs.for_engine(RerankEngine(params, cfg, layout, device="cpu")) is not None
    for got in (cold, warm, aside):
        for a, b in zip(eager[:2], got[:2]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        assert np.array_equal(eager[2], got[2]) and np.array_equal(eager[3], got[3])
        assert eager[4:6] == got[4:6]
        assert all(torch.equal(x, y) for x, y in zip(eager[6], got[6]))
    step_graphs.drop(params)


@pytest.mark.parametrize("packed,has_tvg", [(True, True), (False, False)],
                         ids=["packed-tvg", "rectangle"])
def test_other_passes_run_the_mixture_and_count_its_rows(packed, has_tvg):
    """The packed TVG passes and the rectangle schedule run the mixture of
    experts too, and add its routed rows to the counters and FLOPs."""
    from blim_tpu_torch.data.prompts import make_tvg_layout, make_vtg_layout
    from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
    from blim_tpu_torch.engine.evaluation import EvalInputs, evaluation
    from blim_tpu_torch.engine.rerank import RerankEngine

    cfg = tiny_moe_config()
    params = convert.init_params(cfg, seed=9, device="cpu")
    tok = ByteFallbackTokenizer()
    vtg = make_vtg_layout(tok, "MSRVTT", cfg.video_tokens_vtg, max_caption_tokens=24)
    tvg = make_tvg_layout(tok, cfg.num_clips, 24)
    rng = np.random.default_rng(2)
    caps = ["a cat on a mat", "dogs run", "a red car at night", "people dance"]
    inputs = EvalInputs(caps, np.arange(4), rng.standard_normal(
        (4, cfg.num_clips, cfg.tokens_per_clip, cfg.mm_hidden_size)).astype(np.float32),
        rng.standard_normal((4, 4)).astype(np.float32),
        rng.standard_normal((4, 4)).astype(np.float32))
    engine = RerankEngine(params, cfg, vtg, tvg, device="cpu")
    t2v, _ = evaluation(engine, inputs, tok, "MSRVTT", topk=2, cpn=True, has_tvg=has_tvg,
                        packed=packed, verbose=False)
    assert all(np.isfinite(m).any() for m in t2v.values())
    rows = engine.moe_rows[:, :4].sum() + engine.moe_rows_other[:, :4].sum()
    tokens = engine.moe_tokens.sum() + engine.moe_tokens_other.sum()
    assert rows > 0 and tokens > 0 and engine._pass_counts == []
    assert engine.flops > flops_lib.routed_flops(cfg.llm, rows, tokens)
    assert engine.useful_flops <= engine.flops
