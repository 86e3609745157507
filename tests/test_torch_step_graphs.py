"""The rerank engine's step graphs (engine/step_graphs.py), on the CPU at
the tiny config in fp32 with a stand-in graph in place of
torch.cuda.CUDAGraph (capture runs the step's closure once and keeps it; a
replay runs it again on the static buffers into the captured output, with
the Python counters it moves put back, as a replayed graph runs no Python):

  * the packed evaluation through the graphs (fine-tuned with non-zero
    LoRA B factors, and zero-shot; CPN on) returns the eager matrices bit
    for bit, and every counter (steps, host_syncs, prefix forwards, B1
    launches, FLOPs) as the eager run reads it;
  * a warm cache replays every step and captures none; a cold one captures
    each step key once;
  * two replays of one key within a pass do not alias the pass's pending
    scores (and would without the clone);
  * replacing a LoRA tensor, or changing lora_scale, captures anew, while an
    in-place update of the weights is read by the graphs as they are;
  * a new feature bank is copied into the pass buffers;
  * `RerankEngine.close()` drops its weights' graphs.

One case, marked `cuda`, needs a card (it skips here): graph against eager
packed scores and counters on a 2-layer model at head dim 128 through B1.
"""

import numpy as np
import pytest
import torch

from blim_tpu_torch.adapters.lora import LoraConfig, init_llm_lora, init_projector_lora
from blim_tpu_torch.checkpoints.convert import init_params
from blim_tpu_torch.core.config import tiny_model_config
from blim_tpu_torch.data.prompts import make_tvg_layout, make_vtg_layout
from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
from blim_tpu_torch.engine import rerank, step_graphs
from blim_tpu_torch.engine.evaluation import EvalInputs, evaluation
from blim_tpu_torch.engine.rerank import RerankEngine
from blim_tpu_torch.kernels import flash_attention as fa
from blim_tpu_torch.kernels.attention import multi_head_attention, reference_attention
from blim_tpu_torch.models import qwen2

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
SCALE = LoraConfig().scale
COUNTERS = ("steps", "host_syncs", "prefix_forwards", "tvg_prefix_forwards", "flops",
            "useful_flops")
ENGINES = []        # every engine these tests made: the stand-in restores their counters


class StandInGraph:
    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        saved = ([{n: getattr(e, n) for n in step_graphs.ENGINE_COUNTERS} for e in ENGINES],
                 fa.counts())
        out = self.fn()
        for e, counts in zip(ENGINES, saved[0]):
            for n, v in counts.items():
                setattr(e, n, v)
        fa.reset_counts()
        fa.add_counts(saved[1])
        self.out.copy_(out)


def stand_in(monkeypatch):
    monkeypatch.setattr(step_graphs, "graph_maker", lambda device: StandInGraph)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread an op: beside the other test processes a thread team
    an op is many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def counted_attention():
    """B1's launch counter on the CPU: a prefix forward's attention counts
    as a launch, as it launches B1 on the card."""
    def mha(q, k, v, *, key_mask=None, query_mask=None, causal=True, scale=None, window=None):
        if not torch.is_grad_enabled() and window is None:
            fa.launches += 1
        return reference_attention(q, k, v, key_mask, query_mask, causal, scale, window)

    mp = pytest.MonkeyPatch()
    mp.setattr(qwen2, "multi_head_attention", mha)
    fa.reset_counts()
    yield
    mp.undo()


def _lora(cfg, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(5)
    lora = {"llm": init_llm_lora(gen, cfg.llm, LoraConfig()),
            "projector": init_projector_lora(gen, cfg.mm_hidden_size, cfg.llm.hidden_size,
                                             LoraConfig())}
    for t in step_graphs._tensors(lora):
        if t.shape[-1] != LoraConfig().r:          # a B factor: off zero, so the adapters act
            t.normal_(0.0, 0.02, generator=gen)
    return lora


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal(
        (N, cfg.num_clips, cfg.tokens_per_clip, cfg.mm_hidden_size)).astype(np.float32) * 0.5
    return EvalInputs(CAPTIONS, np.arange(N), feats,
                      rng.standard_normal((N, N)).astype(np.float32) + 0.1,
                      rng.standard_normal((N, N)).astype(np.float32) + 0.1)


class SmallVocabTokenizer(ByteFallbackTokenizer):
    """The byte tokenizer with its special ids moved under 512, so the CPU
    flow's LM head is 512 wide."""

    SPECIALS = {"<|im_start|>": 300, "<|im_end|>": 301, "<|endoftext|>": 302}
    eos_token_id = 301
    pad_token_id = 302


@pytest.fixture(scope="module")
def flow():
    cfg = tiny_model_config(vocab_size=512, num_clips=4)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tok = SmallVocabTokenizer()
    vtg = make_vtg_layout(tok, "MSRVTT", cfg.video_tokens_vtg, max_caption_tokens=48)
    tvg = make_tvg_layout(tok, cfg.num_clips, max_caption_tokens=48)
    return cfg, params, tok, vtg, tvg, _lora(cfg)


def _evaluate(flow, has_tvg, inputs=None, lora="flow", scale=SCALE):
    """One packed evaluation (CPN on) on a fresh engine -> (matrices, engine,
    B1 launches). By default the fine-tuned flow has the flow's LoRA and
    the zero-shot one none."""
    cfg, params, tok, vtg, tvg, flow_lora = flow
    if lora == "flow":
        lora = flow_lora if has_tvg else None
    engine = RerankEngine(params, cfg, vtg, tvg if has_tvg else None, lora=lora,
                          lora_scale=0.0 if lora is None else scale, device="cpu")
    ENGINES.append(engine)
    launches = fa.launches
    t2v, v2t = evaluation(engine, inputs or _inputs(cfg, 0), tok, "MSRVTT", topk=TOPK, cpn=True,
                          has_tvg=has_tvg, verbose=False)
    return {"t2v": t2v, "v2t": v2t}, engine, fa.launches - launches


def _eager(flow, mp, *args, **kwargs):
    """_evaluate with the steps run eagerly (no graphs cached after it)."""
    step_graphs.drop(flow[1])
    with mp.context() as m:
        m.setattr(step_graphs, "graph_maker", lambda device: None)
        return _evaluate(flow, *args, **kwargs)


def _assert_same(got, want):
    for d in want:
        assert set(got[d]) == set(want[d])
        for name in want[d]:
            np.testing.assert_array_equal(got[d][name], want[d][name], err_msg=f"{d} {name}")


def _step_keys(engine):
    return len(step_graphs.for_engine(engine).steps)


@pytest.fixture(scope="module")
def runs(flow):
    """Per has_tvg: the eager run, then a cold and a warm run through the
    stand-in graphs."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for has_tvg in (True, False):
            eager = _eager(flow, mp, has_tvg)
            mp.setattr(step_graphs, "graph_maker", lambda device: StandInGraph)
            cold = _evaluate(flow, has_tvg)
            warm = _evaluate(flow, has_tvg)
            out[has_tvg] = {"eager": eager, "cold": cold, "warm": warm,
                            "keys": _step_keys(cold[1])}
            step_graphs.drop(flow[1])
            mp.undo()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("has_tvg", [True, False])
@pytest.mark.parametrize("run", ["cold", "warm"])
def test_graphs_return_the_eager_matrices_bit_for_bit(runs, has_tvg, run):
    _assert_same(runs[has_tvg][run][0], runs[has_tvg]["eager"][0])


@pytest.mark.parametrize("has_tvg", [True, False])
@pytest.mark.parametrize("run", ["cold", "warm"])
def test_graphs_read_the_eager_counters(runs, has_tvg, run):
    (_, eager, b1), (_, got, b1_got) = runs[has_tvg]["eager"], runs[has_tvg][run]
    assert {n: getattr(got, n) for n in COUNTERS} == {n: getattr(eager, n) for n in COUNTERS}
    assert b1_got == b1 > 0
    assert eager.graph_captures == eager.graph_replays == 0


@pytest.mark.parametrize("has_tvg", [True, False])
def test_a_cold_cache_captures_each_key_once_and_a_warm_one_replays(runs, has_tvg):
    r = runs[has_tvg]
    cold, warm = r["cold"][1], r["warm"][1]
    assert cold.graph_captures == r["keys"] > 0
    assert cold.graph_captures + cold.graph_replays == cold.steps
    assert warm.graph_captures == 0 and warm.graph_replays == warm.steps


def test_two_replays_of_a_key_in_a_pass_keep_their_own_scores(flow, monkeypatch):
    """One pack a step, so a pack size's steps share a key: the pass's
    pending outputs are clones, not the key's static output."""
    monkeypatch.setattr(rerank, "G_CAP", 1)
    eager = _eager(flow, monkeypatch, True)[0]
    stand_in(monkeypatch)
    got, engine, _ = _evaluate(flow, True)
    assert engine.graph_replays > 0        # a key came back within its pass
    _assert_same(got, eager)
    # the control: without the clone, the pending scores alias
    monkeypatch.setattr(step_graphs.StepGraphs, "run",
                        lambda self, engine, st, forward: _uncloned(self, engine, st, forward))
    step_graphs.drop(flow[1])
    aliased = _evaluate(flow, True)[0]
    assert not np.array_equal(aliased["v2t"]["candidate_likelihood"],
                              eager["v2t"]["candidate_likelihood"])
    step_graphs.drop(flow[1])


def _uncloned(graphs, engine, st, forward):
    if st.graph is None:
        st.graph = graphs.new_graph()
        st.output = st.graph.capture(lambda: forward(st.inputs))
    st.graph.replay()
    return st.output


def test_new_lora_tensors_or_scale_capture_anew_and_in_place_updates_do_not(flow, monkeypatch):
    lora = _lora(flow[0])
    swapped = dict(lora, llm=dict(lora["llm"], lm_head={
        "a": lora["llm"]["lm_head"]["a"].clone(), "b": lora["llm"]["lm_head"]["b"] * 2}))
    cases = ((swapped, SCALE), (swapped, SCALE / 2))
    wants = [_eager(flow, monkeypatch, True, lora=tree, scale=scale)[0] for tree, scale in cases]
    stand_in(monkeypatch)
    _evaluate(flow, True, lora=lora)
    # a new tensor in the tree, then a new scale: each captures anew
    for (tree, scale), want in zip(cases, wants):
        got, engine, _ = _evaluate(flow, True, lora=tree, scale=scale)
        assert engine.graph_captures == _step_keys(engine) > 0
        _assert_same(got, want)
    # in place, as AdamW updates the trainable tree: the graphs read it
    _evaluate(flow, True, lora=lora)
    with torch.no_grad():
        lora["llm"]["layers"]["q_proj"]["b"].mul_(1.5)
    got, engine, _ = _evaluate(flow, True, lora=lora)
    assert engine.graph_captures == 0
    _assert_same(got, _eager(flow, monkeypatch, True, lora=lora)[0])


def test_a_new_bank_is_copied_into_the_pass_buffers(flow, monkeypatch):
    cfg = flow[0]
    other = _inputs(cfg, 1)
    want = _eager(flow, monkeypatch, True, inputs=other)[0]
    stand_in(monkeypatch)
    first = _evaluate(flow, True)[0]
    got, engine, _ = _evaluate(flow, True, inputs=other)
    assert engine.graph_captures == 0 and engine.graph_replays == engine.steps
    _assert_same(got, want)
    assert not np.array_equal(got["v2t"]["candidate_likelihood"],
                              first["v2t"]["candidate_likelihood"])
    step_graphs.drop(flow[1])


def test_a_bank_of_another_size_drops_the_graphs_into_a_new_pool(flow, monkeypatch):
    """Six videos where there were eight: the feature buffer is made anew,
    the graphs that read the old one go, and the new captures take a new
    maker (a new memory pool on the card)."""
    cfg = flow[0]
    inp = _inputs(cfg, 2)
    six = EvalInputs(inp.captions, np.arange(N) % 6, inp.features[:6], inp.t2v_iv2,
                     inp.v2t_iv2)
    want = _eager(flow, monkeypatch, False, inputs=six)[0]
    makers = []
    monkeypatch.setattr(step_graphs, "graph_maker",
                        lambda device: makers.append(device) or StandInGraph)
    _evaluate(flow, False)
    n_makers = len(makers)
    got, engine, _ = _evaluate(flow, False, inputs=six)
    assert len(makers) == n_makers + 1
    assert engine.graph_captures == _step_keys(engine) > 0
    _assert_same(got, want)
    step_graphs.drop(flow[1])


def test_close_drops_the_weights_graphs(flow, monkeypatch):
    stand_in(monkeypatch)
    step_graphs.drop(flow[1])
    _, engine, _ = _evaluate(flow, False)
    key = flow[1]["llm"]["embed_tokens"]["embedding"]
    assert key in step_graphs._CACHES
    engine.close()
    assert key not in step_graphs._CACHES
    engine.close()                           # idempotent


def test_the_cpu_runs_eagerly(flow):
    assert step_graphs.graph_maker(torch.device("cpu")) is None
    step_graphs.drop(flow[1])
    _, engine, _ = _evaluate(flow, False)
    assert step_graphs.for_engine(engine) is None
    assert engine.graph_captures == engine.graph_replays == 0


@pytest.mark.cuda
def test_graphs_match_eager_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(qwen2, "multi_head_attention", multi_head_attention)
    cfg = tiny_model_config(vocab_size=152064, hidden_size=256, num_attention_heads=2,
                            num_key_value_heads=1, intermediate_size=512, num_clips=4)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    tok = ByteFallbackTokenizer()
    vtg = make_vtg_layout(tok, "MSRVTT", cfg.video_tokens_vtg, max_caption_tokens=48)
    tvg = make_tvg_layout(tok, cfg.num_clips, max_caption_tokens=48)
    lora = _lora(cfg, device="cuda")

    inp = _inputs(cfg, 0)
    six = EvalInputs(inp.captions, np.arange(N) % 6, inp.features[:6], inp.t2v_iv2,
                     inp.v2t_iv2)

    def run(inputs):
        engine = RerankEngine(params, cfg, vtg, tvg, lora=lora, lora_scale=SCALE)
        fa.reset_counts()
        t2v, v2t = evaluation(engine, inputs, tok, "MSRVTT", topk=TOPK, cpn=True, has_tvg=True,
                              verbose=False)
        torch.cuda.synchronize()
        counts = {n: getattr(engine, n) for n in COUNTERS}
        return {"t2v": t2v, "v2t": v2t}, counts, fa.launches, engine

    with monkeypatch.context() as m:
        m.setattr(step_graphs, "graph_maker", lambda device: None)
        wants = {id(x): run(x) for x in (inp, six)}
    step_graphs.drop(params)
    # cold, warm, then a bank of six videos: its buffer is laid out anew,
    # and the captures go to a new memory pool
    for inputs, cold in ((inp, True), (inp, False), (six, True)):
        want, want_counts, want_b1, _ = wants[id(inputs)]
        got, counts, b1, engine = run(inputs)
        assert counts == want_counts and b1 == want_b1 > 0
        assert (engine.graph_captures > 0) == cold
        assert engine.graph_captures + engine.graph_replays == engine.steps
        gap = max(float(np.abs(got[d][k] - want[d][k]).max()) for d in want for k in want[d])
        print(f"graphs against eager on the card, {len(inputs.features)} videos, "
              f"{'cold' if cold else 'warm'}: max|d| {gap:.3e}")
        for d in want:
            for name in want[d]:
                np.testing.assert_allclose(got[d][name], want[d][name], rtol=0, atol=1e-3,
                                           err_msg=f"{d} {name}")
    step_graphs.drop(params)
