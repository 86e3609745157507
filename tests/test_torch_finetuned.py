"""The port's fine-tuned flow end to end against the JAX package's: the
evaluation with CPN on and the TVG directions on (VTG and TVG packed
scoring, both CPN priors) on 8 items with topk 4, with a LoRA tree on the
LLM and the projector, gives the same six score matrices, the same two
InternVideo2 matrices and the same recall tables as the JAX evaluation on a
one-device mesh. Tiny config, fp32 on the CPU, weights and LoRA (B factors
made non-zero so the adapters act) bridged from the JAX trees; matrices
within atol 1e-4 / rtol 1e-4 (fp32 through two layers and a 152k-way CE),
fill cells exactly -100, recall tables equal.

Also: no kernel launches on the CPU, a bank uploaded before the LoRA
changed refuses to score, and each pass adds to the engine's `flops` and
`useful_flops` what the JAX engine's pass adds (`trace_flops`)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blim_tpu.core.config import tiny_model_config as jax_tiny_config
from blim_tpu.core.mesh import make_mesh
from blim_tpu.data.prompts import make_tvg_layout as jax_make_tvg_layout
from blim_tpu.data.prompts import make_vtg_layout as jax_make_vtg_layout
from blim_tpu.engine import evaluation as jeval
from blim_tpu.engine.rerank import RerankEngine as JaxRerankEngine
from blim_tpu.models import videochat_flash as jvcf
from blim_tpu.scoring import fusion as jfusion

from blim_tpu_torch.adapters.lora import LoraConfig
from blim_tpu_torch.checkpoints.convert import params_from_numpy
from blim_tpu_torch.core.config import tiny_model_config
from blim_tpu_torch.data.prompts import make_tvg_layout, make_vtg_layout
from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
from blim_tpu_torch.engine import evaluation as teval
from blim_tpu_torch.engine.rerank import CaptionBank, RerankEngine, topk_pairs
from blim_tpu_torch.kernels import flash_attention as tfa
from blim_tpu_torch.scoring import fusion as tfusion
from test_torch_tvg import _lora_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N, TOPK = 8, 4
SCALE = LoraConfig().scale
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
V2T = ("v2t", "candidate_likelihood", "candidate_prior", "query_likelihood")
T2V = ("t2v", "query_likelihood", "candidate_likelihood", "candidate_prior")
SCORED = [(V2T[0], name) for name in V2T[1:]] + [(T2V[0], name) for name in T2V[1:]]
MATRICES = SCORED + [("v2t", "internvideo2"), ("t2v", "internvideo2")]
PASSES = ("score_pairs_vtg_packed", "compute_vtg_priors_packed", "score_pairs_tvg_packed",
          "score_pairs_vtg_shared", "compute_vtg_priors", "score_pairs_tvg_shared",
          "score_grid_vtg", "score_grid_tvg")


def trace_flops(engine):
    """Wrap every scoring pass of `engine` (either package's) to log (pass,
    flops it added, useful_flops it added), each counted from zero so that
    the order of the passes cannot round them. Returns the log."""
    log = []
    for name in PASSES:
        def wrapped(*a, _name=name, _real=getattr(engine, name), **k):
            f0, u0 = engine.flops, engine.useful_flops
            engine.flops = engine.useful_flops = 0.0
            out = _real(*a, **k)
            log.append((_name, engine.flops, engine.useful_flops))
            engine.flops, engine.useful_flops = f0 + engine.flops, u0 + engine.useful_flops
            return out
        setattr(engine, name, wrapped)
    return log


def assert_flops_match(got_log, want_log, got_engine, want_engine):
    """The same passes, each adding the same dispatched and useful FLOPs."""
    by_pass = lambda log: sorted(log, key=lambda r: r[0])  # noqa: E731  (stable)
    assert by_pass(got_log) == by_pass(want_log)
    assert len(got_log) > 0 and all(f > 0 and u > 0 for _, f, u in got_log)
    assert got_engine.flops == pytest.approx(want_engine.flops, rel=1e-12)
    assert got_engine.useful_flops == pytest.approx(want_engine.useful_flops, rel=1e-12)


@pytest.fixture(scope="module")
def both(tokenizer):
    jcfg = jax_tiny_config(vocab_size=152064, num_clips=4)
    tcfg = tiny_model_config(vocab_size=152064, num_clips=4)
    jp = jvcf.init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), torch.float32, "cpu")
    lora_np = _lora_numpy(jcfg, 5)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal(
        (N, tcfg.num_clips, tcfg.tokens_per_clip, tcfg.mm_hidden_size)).astype(np.float32) * 0.5
    # InternVideo2 stand-ins, kept off exact 0.0 (the recall sentinel)
    t2v_iv2 = rng.standard_normal((N, N)).astype(np.float32) + 0.1
    v2t_iv2 = rng.standard_normal((N, N)).astype(np.float32) + 0.1

    jvtg = jax_make_vtg_layout(tokenizer, "MSRVTT", jcfg.video_tokens_vtg, max_caption_tokens=48)
    jtvg = jax_make_tvg_layout(tokenizer, jcfg.num_clips, max_caption_tokens=48)
    jengine = JaxRerankEngine(jp, jcfg, jvtg, jtvg, make_mesh(devices=jax.devices()[:1]),
                              lora=jax.tree_util.tree_map(jnp.asarray, lora_np),
                              lora_scale=SCALE)
    jflops = trace_flops(jengine)
    jt2v, jv2t = jeval.evaluation(
        jengine, jeval.EvalInputs(CAPTIONS, np.arange(N), feats, t2v_iv2, v2t_iv2),
        tokenizer, "MSRVTT", topk=TOPK, cpn=True, has_tvg=True, verbose=False)

    ttok = ByteFallbackTokenizer()
    tvtg = make_vtg_layout(ttok, "MSRVTT", tcfg.video_tokens_vtg, max_caption_tokens=48)
    ttvg = make_tvg_layout(ttok, tcfg.num_clips, max_caption_tokens=48)
    tengine = RerankEngine(tp, tcfg, tvtg, ttvg, lora=params_from_numpy(lora_np, device="cpu"),
                           lora_scale=SCALE, device="cpu")
    tflops = trace_flops(tengine)
    tfa.reset_counts()
    inputs = teval.EvalInputs(CAPTIONS, np.arange(N), feats, t2v_iv2, v2t_iv2)
    tt2v, tv2t = teval.evaluation(tengine, inputs, ttok, "MSRVTT", topk=TOPK, cpn=True,
                                  has_tvg=True, verbose=False)
    return {"jax": {"t2v": jt2v, "v2t": jv2t}, "torch": {"t2v": tt2v, "v2t": tv2t},
            "v2t_iv2": v2t_iv2, "t2v_iv2": t2v_iv2, "counts": tfa.counts(),
            "engine": tengine, "inputs": inputs, "tokenizer": ttok,
            "flops": (tflops, jflops, tengine, jengine)}


@pytest.mark.parametrize("direction,name", MATRICES, ids=[f"{d}-{n}" for d, n in MATRICES])
def test_finetuned_matrices_match_jax(both, direction, name):
    t = both["torch"][direction][name]
    j = both["jax"][direction][name]
    assert t.shape == j.shape == (N, N)
    np.testing.assert_array_equal(t == -100.0, j == -100.0)
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=1e-4)


def test_finetuned_keys_and_fill(both):
    t = both["torch"]
    for direction in ("v2t", "t2v"):
        assert set(t[direction]) == set(both["jax"][direction])
    grids = {"v2t": topk_pairs(both["v2t_iv2"], TOPK), "t2v": topk_pairs(both["t2v_iv2"], TOPK)}
    for direction, name in SCORED:
        rows, cols = grids[direction]
        owned = np.zeros((N, N), bool)
        owned[rows, cols] = True
        mat = t[direction][name]
        assert (mat[~owned] == -100.0).all(), (direction, name)
        assert np.isfinite(mat[owned]).all(), (direction, name)
        assert (mat[owned] > -100.0).all() and (mat[owned] != 0.0).all(), (direction, name)


@pytest.mark.parametrize("cpn", [True, False])
def test_finetuned_recall_tables_match_jax(both, cpn):
    ids = {i: i for i in range(N)}
    args = (ids, ids, (0.3, 0.8), (1.0, 0.5, 0.8, 0.6), cpn, True)
    t = tfusion.all_scoring_results(both["torch"]["t2v"], both["torch"]["v2t"], *args)
    j = jfusion.all_scoring_results(both["jax"]["t2v"], both["jax"]["v2t"], *args)
    assert t == j


def test_finetuned_flops_match_jax(both):
    """Each packed pass (the VTG pass, the VTG priors, TVG with its prior
    pass) adds JAX's dispatched and useful FLOPs, on the same step geometry."""
    tlog, jlog, tengine, jengine = both["flops"]
    assert {p for p, _, _ in tlog} == {"score_pairs_vtg_packed", "compute_vtg_priors_packed",
                                       "score_pairs_tvg_packed"}
    assert_flops_match(tlog, jlog, tengine, jengine)
    assert tengine.useful_flops < tengine.flops


def test_cpu_finetuned_flow_never_launches_a_kernel(both):
    assert sum(both["counts"].values()) == 0
    engine = both["engine"]
    assert engine.prefix_forwards > 1 and engine.tvg_prefix_forwards > 1


def test_rescoring_after_the_lora_changes_raises(both):
    """A TVG bank bakes the projector LoRA into its video embeddings: once
    engine.lora is another tree, scoring with that bank refuses."""
    engine, inputs = both["engine"], both["inputs"]
    bank = CaptionBank.build_tvg(inputs.captions, both["tokenizer"], engine.tvg_layout)
    banks = engine.upload(bank, inputs.features)
    vocab = engine.video_vocab(banks)
    cap, vid = np.arange(2), np.arange(2)
    engine.score_pairs_tvg_packed(banks, vocab, cap, vid, with_prior=False)
    old = engine.lora
    engine.lora = {k: dict(v) for k, v in old.items()}
    try:
        with pytest.raises(AssertionError, match="stale"):
            engine.score_pairs_tvg_packed(banks, vocab, cap, vid, with_prior=False)
        fresh = engine.upload(bank, inputs.features)
        engine.score_pairs_tvg_packed(fresh, vocab, cap, vid, with_prior=False)
    finally:
        engine.lora = old
