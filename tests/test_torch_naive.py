"""The naive per-pair schedule (`evaluation(shared_prefix=False)`,
`RerankEngine.score_grid_vtg` / `score_grid_tvg`) against the JAX package's,
on the CPU at the tiny config in fp32: zero-shot and fine-tuned (a LoRA tree
with non-zero B factors), every matrix within 1e-4 of JAX's naive
evaluation, and of the port's packed evaluation within PACKED_TOL (3e-4,
tests/test_torch_tvg.py's packed-vs-naive tolerance); the fill cells
agree; pairs go 16 a step with the tail padded, the candidate grids with a
second (prior) forward; each grid adds to the engine's `flops` and
`useful_flops` what the JAX engine's grid adds.
"""

import numpy as np
import pytest

from test_torch_distributed import ATOL, CELL_IDS, CELLS, FLOWS, N, RTOL, SCALE, TOPK, CAPTIONS

PACKED_TOL = 3e-4


@pytest.fixture(scope="module")
def naive(tokenizer):
    import jax
    import jax.numpy as jnp
    import torch

    from blim_tpu.core.config import tiny_model_config as jax_tiny_config
    from blim_tpu.core.mesh import make_mesh
    from blim_tpu.data.prompts import make_tvg_layout as jax_tvg_layout
    from blim_tpu.data.prompts import make_vtg_layout as jax_vtg_layout
    from blim_tpu.engine import evaluation as jeval
    from blim_tpu.engine.rerank import RerankEngine as JaxRerankEngine
    from blim_tpu.models import videochat_flash as jvcf
    from test_torch_distributed import CAPS, _engine, _eval
    from test_torch_finetuned import trace_flops
    from test_torch_tvg import _lora_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    jcfg = jax_tiny_config(vocab_size=152064, num_clips=4)
    jp = jvcf.init_params(jcfg, jax.random.key(0))
    lora_np = _lora_numpy(jcfg, 7)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal(
        (N, jcfg.num_clips, jcfg.tokens_per_clip, jcfg.mm_hidden_size)).astype(np.float32) * 0.5
    ev = {"feats": feats, "t2v": rng.standard_normal((N, N)).astype(np.float32) + 0.1,
          "v2t": rng.standard_normal((N, N)).astype(np.float32) + 0.1}
    inp = {"params": jax.tree_util.tree_map(np.asarray, jp), "lora": lora_np, "eval": ev}
    jvtg = jax_vtg_layout(tokenizer, "MSRVTT", jcfg.video_tokens_vtg, CAPS)
    jtvg = jax_tvg_layout(tokenizer, jcfg.num_clips, CAPS)
    mesh = make_mesh(devices=jax.devices()[:1])
    out = {}
    for flow, has_tvg in FLOWS.items():
        jengine = JaxRerankEngine(
            jp, jcfg, jvtg, jtvg, mesh,
            lora=jax.tree_util.tree_map(jnp.asarray, lora_np) if has_tvg else None,
            lora_scale=SCALE)
        jlog = trace_flops(jengine)
        t2v, v2t = jeval.evaluation(
            jengine, jeval.EvalInputs(CAPTIONS, np.arange(N), feats, ev["t2v"], ev["v2t"]),
            tokenizer, "MSRVTT", topk=TOPK, cpn=True, has_tvg=has_tvg, verbose=False,
            shared_prefix=False)
        out[flow, "jax"] = {"t2v": t2v, "v2t": v2t}
        out[flow, "packed"], _ = _eval(inp, has_tvg)
        engine, _ = _engine(inp, has_tvg)
        tlog = trace_flops(engine)
        out[flow, "naive"], engine = _eval(inp, has_tvg, shared_prefix=False, engine=engine)
        out[flow, "engine"] = engine
        out[flow, "flops"] = (tlog, jlog, engine, jengine)
    return out


@pytest.mark.parametrize("flow,direction,name", CELLS, ids=CELL_IDS)
def test_naive_evaluation_matches_jax_and_packed(naive, flow, direction, name):
    t = naive[flow, "naive"][direction][name]
    j = naive[flow, "jax"][direction][name]
    packed = naive[flow, "packed"][direction][name]
    assert t.shape == j.shape == (N, N)
    np.testing.assert_array_equal(t == -100.0, j == -100.0)
    np.testing.assert_array_equal(t == -100.0, packed == -100.0)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(t, packed, atol=PACKED_TOL, rtol=PACKED_TOL)


@pytest.mark.parametrize("flow", list(FLOWS))
def test_naive_schedule_steps_and_forwards(naive, flow):
    """16 pairs a step, the tail padded: each grid of N * TOPK pairs; the
    two candidate grids (v2t VTG, t2v TVG) run a second, prior forward a
    step; no packed prefix runs."""
    engine = naive[flow, "engine"]
    steps_per_grid = -(-N * TOPK // 16)
    grids = 4 if FLOWS[flow] else 2
    priors = 2 if FLOWS[flow] else 1
    assert engine.steps == grids * steps_per_grid
    assert engine.naive_forwards == (grids + priors) * steps_per_grid
    assert engine.prefix_forwards == engine.tvg_prefix_forwards == 0
    assert engine.pack_shards == []


@pytest.mark.parametrize("flow", list(FLOWS))
def test_naive_flops_match_jax(naive, flow):
    """Each naive grid adds JAX's full-forward FLOPs a step (two with the
    prior) and its useful FLOPs."""
    from test_torch_finetuned import assert_flops_match

    tlog, jlog, engine, jengine = naive[flow, "flops"]
    assert [p for p, _, _ in tlog] == ["score_grid_vtg"] * 2 + ["score_grid_tvg"] * 2 * FLOWS[flow]
    assert_flops_match(tlog, jlog, engine, jengine)
