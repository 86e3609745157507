"""The rectangle schedule (`evaluation(packed=False)`) of the port against
the JAX package's, on the CPU at the tiny config in fp32 (JAX's attention on
its XLA path, as its own tests run it on the CPU):

  * the grouping helpers (`group_pairs`, `group_pairs_bucketed`,
    `group_pairs_by_video`) exactly, on seeded pair lists that reach every
    remainder bucket;
  * `score_vtg_suffix`; `tvg_prefix_kv` on left-padded prefixes trimmed from
    the left to a width with their absolute positions, under the attention
    mask and the CPN mask; `score_tvg_shared` with 4-D (projected) and 5-D
    (raw) video, CPN on and off;
  * the engine's passes (`score_pairs_vtg_shared`, `compute_vtg_priors`,
    `score_pairs_tvg_shared` with and without priors, `score_grid_*_shared`),
    with the step counts, prefix forwards and shards they record;
  * the whole `evaluation(packed=False)`, zero-shot and fine-tuned with CPN
    and a LoRA tree whose B factors are non-zero: all 8 matrices within
    atol 1e-4 / rtol 1e-4 of JAX's, the fill cells and recall tables equal;
    and against the port's packed evaluation within PACKED_TOL (3e-4, the
    packed-vs-naive tolerance of tests/test_torch_tvg.py: both schedules
    compute every score in another order).
"""

import inspect

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blim_tpu.core.mesh import make_mesh
from blim_tpu.data.prompts import make_tvg_layout as jax_make_tvg_layout
from blim_tpu.data.prompts import make_vtg_layout as jax_make_vtg_layout
from blim_tpu.engine import rerank as jrerank
from blim_tpu.models import videochat_flash as jvcf
from blim_tpu.scoring import fusion as jfusion

from blim_tpu_torch.data.prompts import make_tvg_layout, make_vtg_layout
from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
from blim_tpu_torch.engine import rerank as trerank
from blim_tpu_torch.engine.rerank import CaptionBank, RerankEngine
from blim_tpu_torch.models import videochat_flash as tvcf
from blim_tpu_torch.scoring import fusion as tfusion
from test_torch_distributed import (ATOL, CAPS, CAPTIONS, CELL_IDS, CELLS, FLOWS, N,
                                    RECT_PRIOR_BATCH, RTOL, SCALE)
from test_torch_tvg import _close, _randn, _t, setup  # noqa: F401  (setup is a fixture)

PACKED_TOL = 3e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops at the tiny config: one intra-op thread keeps them
    from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the grouping helpers, exactly
# ---------------------------------------------------------------------------

def _pairs(seed, n_keys=12, k_main=32):
    """A shuffled pair list whose keys hold 1..2 * k_main + 17 pairs, so that
    full groups and every remainder bucket (16, 8, 4, k_main) occur."""
    rng = np.random.default_rng(seed)
    counts = np.concatenate([[k_main, 2 * k_main + 3, 17, 9, 5, 1],
                             rng.integers(1, 2 * k_main + 17, n_keys - 6)])
    key = np.repeat(rng.permutation(n_keys * 3)[:n_keys], counts)
    payload = rng.integers(0, 500, len(key))
    order = rng.permutation(len(key))
    return key[order].astype(np.int32), payload[order].astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [3, 32])
def test_group_pairs_copy_matches(seed, k):
    key, payload = _pairs(seed)
    for t, j in zip(trerank.group_pairs(key, payload, k), jrerank.group_pairs(key, payload, k)):
        np.testing.assert_array_equal(t, j)
        assert t.dtype == j.dtype


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k_main", [32, 6])
def test_group_pairs_bucketed_copy_matches(seed, k_main):
    key, payload = _pairs(seed, k_main=k_main)
    t = trerank.group_pairs_bucketed(key, payload, k_main)
    j = jrerank.group_pairs_bucketed(key, payload, k_main)
    assert [b[0] for b in t] == [b[0] for b in j]
    if k_main == 32:
        assert [b[0] for b in t] == [32, 16, 8, 4]
    for tb, jb in zip(t, j):
        for ta, ja in zip(tb[1:], jb[1:]):
            np.testing.assert_array_equal(ta, ja)
            assert ta.dtype == ja.dtype
    # a padded slot repeats its group's first pair; every pair is scored once
    for k, g_key, g_pay, g_pos in t:
        pad = g_pos == g_pos[:, :1]
        np.testing.assert_array_equal(g_pay[pad], np.repeat(g_pay[:, 0], pad.sum(axis=1)))
        np.testing.assert_array_equal(key[g_pos], np.repeat(g_key[:, None], k, axis=1))
    assert sorted(set(np.concatenate([g[3].ravel() for g in t]).tolist())) == list(range(len(key)))


def test_group_pairs_by_video_copy_matches():
    key, payload = _pairs(3)
    rows, cols = np.arange(len(key)) * 7, np.arange(len(key)) * 3
    for t, j in zip(trerank.group_pairs_by_video(rows, cols, key, payload, 5),
                    jrerank.group_pairs_by_video(rows, cols, key, payload, 5)):
        np.testing.assert_array_equal(t, j)


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------

def _left_padded(rng, g, p_full, lens, vocab=1000):
    ids = np.zeros((g, p_full), np.int32)
    mask = np.zeros((g, p_full), np.int32)
    for i, L in enumerate(lens):
        ids[i, p_full - L:] = rng.integers(1, vocab, L)
        mask[i, p_full - L:] = 1
    return ids, mask


def _prefix_kv(jcfg, tcfg, jp, tp, jl, tl, ids, mask, positions):
    jkv = jvcf.tvg_prefix_kv(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                             position_ids=jnp.asarray(positions), lora=jl, lora_scale=SCALE)
    tkv = tvcf.tvg_prefix_kv(tp, tcfg, _t(ids), _t(mask), position_ids=_t(positions), lora=tl,
                             lora_scale=SCALE)
    return jkv, tkv


# a row trimmed to width B keeps the columns P_FULL - B + j; LENS fit in B
P_FULL, WIDTH, LENS = 40, 24, (24, 9, 17)


@pytest.mark.parametrize("cpn", [False, True], ids=["mask", "cpn_mask"])
def test_tvg_prefix_kv_trimmed_matches_jax(setup, cpn):
    jcfg, tcfg, jp, tp, jl, tl = setup
    rng = np.random.default_rng(4)
    ids, mask = _left_padded(rng, len(LENS), P_FULL, LENS)
    if cpn:   # only the first 5 real tokens (the instruction head) stay visible
        for i, L in enumerate(LENS):
            mask[i, P_FULL - L + 5:] = 0
    off = P_FULL - WIDTH
    pos = np.broadcast_to(off + np.arange(WIDTH), (len(LENS), WIDTH)).astype(np.int32)
    jkv, tkv = _prefix_kv(jcfg, tcfg, jp, tp, jl, tl, ids[:, off:], mask[:, off:], pos)
    for key in ("k", "v"):
        _close(tkv[key], jkv[key])
    # positions matter: the same row at positions 0..B-1 gives other keys
    _, moved = _prefix_kv(jcfg, tcfg, jp, tp, jl, tl, ids[:, off:], mask[:, off:], pos - off)
    assert not torch.allclose(moved["k"], tkv["k"], atol=1e-3)


def test_score_vtg_suffix_matches_jax(setup):
    jcfg, tcfg, jp, tp, jl, tl = setup
    rng = np.random.default_rng(5)
    g, k, w, p = 2, 3, 7, 11
    ids, mask = _left_padded(rng, g, p, (11, 8))
    pos = np.broadcast_to(np.arange(p), (g, p)).astype(np.int32)
    jkv, tkv = _prefix_kv(jcfg, tcfg, jp, tp, jl, tl, ids, mask, pos)
    suf = rng.integers(1, 1000, (g, k, w)).astype(np.int32)
    smask = np.ones((g, k, w), np.int32)
    smask[0, 1, 4:] = 0
    smask[1, 2, 2:] = 0
    labels = np.where(smask[..., 1:] > 0, suf[..., 1:], -100).astype(np.int32)
    want = jvcf.score_vtg_suffix(jp, jcfg, jkv, jnp.asarray(suf), jnp.asarray(smask),
                                 jnp.asarray(labels), p, prefix_mask=jnp.asarray(mask),
                                 lora=jl, lora_scale=SCALE)
    got = tvcf.score_vtg_suffix(tp, tcfg, tkv, _t(suf), _t(smask), _t(labels), p,
                                prefix_mask=_t(mask), lora=tl, lora_scale=SCALE)
    assert got.shape == (g, k)
    _close(got, want)


@pytest.mark.parametrize("cpn", [False, True], ids=["likelihood", "prior"])
@pytest.mark.parametrize("raw", [False, True], ids=["embeds4d", "features5d"])
def test_score_tvg_shared_matches_jax(setup, cpn, raw):
    jcfg, tcfg, jp, tp, jl, tl = setup
    rng = np.random.default_rng(6)
    g, k, v = 2, 3, 5
    ids, mask = _left_padded(rng, g, P_FULL, (30, 12))
    pos = np.broadcast_to(np.arange(P_FULL), (g, P_FULL)).astype(np.int32)
    jkv, tkv = _prefix_kv(jcfg, tcfg, jp, tp, jl, tl, ids, mask, pos)
    first = rng.integers(1, 1000, g).astype(np.int32)
    labels = rng.integers(0, v, (g, k)).astype(np.int32)
    vocab = _randn(rng, v, tcfg.num_clips, tcfg.mm_hidden_size)
    if raw:
        video = _randn(rng, g, k, tcfg.num_clips, tcfg.tokens_per_clip, tcfg.mm_hidden_size,
                       scale=0.5)
    else:
        video = _randn(rng, g, k, tcfg.num_clips, tcfg.llm.hidden_size, scale=0.5)
    term = (151645, 198)
    want = jvcf.score_tvg_shared(jp, jcfg, jkv, jnp.asarray(mask), jnp.asarray(first),
                                 jnp.asarray(video), jnp.asarray(labels), jnp.asarray(vocab), term,
                                 P_FULL, cpn=cpn, lora=jl, lora_scale=SCALE)
    got = tvcf.score_tvg_shared(tp, tcfg, tkv, _t(mask), _t(first), _t(video), _t(labels),
                                _t(vocab), term, P_FULL, cpn=cpn, lora=tl, lora_scale=SCALE)
    assert got.shape == (g, k)
    _close(got, want)


# ---------------------------------------------------------------------------
# the engine's passes
# ---------------------------------------------------------------------------

ENGINE_CAPS = 32
ENGINE_TOPK = 6
PRIOR_BATCH = RECT_PRIOR_BATCH   # captions a prior step in both packages (64 by
                  # default): the 8 captions then take more than one step a width
                  # bucket, and the padding of a 152k-vocabulary CE stays small


@pytest.fixture(scope="module")
def engines(setup, tokenizer):
    """Both engines with the fine-tuned LoRA, their banks over the 8
    captions and features, and a pair list whose videos and captions hold
    1..8 pairs each (full groups of ENGINE_TOPK and every remainder)."""
    jcfg, tcfg, jp, tp, jl, tl = setup
    rng = np.random.default_rng(7)
    feats = _randn(rng, N, tcfg.num_clips, tcfg.tokens_per_clip, tcfg.mm_hidden_size, scale=0.5)
    jengine = jrerank.RerankEngine(
        jp, jcfg, jax_make_vtg_layout(tokenizer, "MSRVTT", jcfg.video_tokens_vtg, ENGINE_CAPS),
        jax_make_tvg_layout(tokenizer, jcfg.num_clips, ENGINE_CAPS),
        make_mesh(devices=jax.devices()[:1]), lora=jl, lora_scale=SCALE,
        prior_batch=PRIOR_BATCH)
    tok = ByteFallbackTokenizer()
    tengine = RerankEngine(tp, tcfg, make_vtg_layout(tok, "MSRVTT", tcfg.video_tokens_vtg,
                                                     ENGINE_CAPS),
                           make_tvg_layout(tok, tcfg.num_clips, ENGINE_CAPS), lora=tl,
                           lora_scale=SCALE, prior_batch=PRIOR_BATCH, device="cpu")
    jb = {"vtg": jengine.upload(jrerank.CaptionBank.build_vtg(CAPTIONS, tokenizer, "MSRVTT",
                                                              jengine.vtg_layout), feats)}
    jb["tvg"] = jengine.upload(jrerank.CaptionBank.build_tvg(CAPTIONS, tokenizer,
                                                             jengine.tvg_layout), feats)
    tb = {"vtg": tengine.upload(CaptionBank.build_vtg(CAPTIONS, tok, "MSRVTT",
                                                      tengine.vtg_layout), feats)}
    tb["tvg"] = tengine.upload(CaptionBank.build_tvg(CAPTIONS, tok, tengine.tvg_layout), feats)
    counts = [8, 6, 7, 1, 3, 5, 2, 4]      # pairs a video: one full group, then remainders
    vid = np.repeat(np.arange(N), counts)
    cap = np.concatenate([rng.permutation(N)[:c] for c in counts])
    order = rng.permutation(len(vid))
    return dict(jengine=jengine, tengine=tengine, jb=jb, tb=tb, cap=cap[order], vid=vid[order],
                jvocab=jengine.video_vocab(jb["vtg"], feats), tvocab=tengine.video_vocab(tb["vtg"]))


def test_rectangle_buckets_copy_the_engines(engines):
    j, t = engines["jengine"], engines["tengine"]
    assert t.suffix_buckets == j.suffix_buckets and t.suffix_buckets[-1] == t.vtg_layout.suffix_width
    assert t.tvg_prefix_buckets == j.tvg_prefix_buckets
    assert (t.groups_per_step, t.prior_batch) == (j.groups_per_step, j.prior_batch)
    for name in ("groups_per_step", "prior_batch"):
        want = inspect.signature(jrerank.RerankEngine).parameters[name].default
        assert inspect.signature(RerankEngine).parameters[name].default == want, name


def test_score_pairs_vtg_shared_matches_jax(engines):
    e = engines
    t = e["tengine"]
    t.steps = t.prefix_forwards = 0
    t.pack_shards.clear()
    got = t.score_pairs_vtg_shared(e["tb"]["vtg"], e["cap"], e["vid"], ENGINE_TOPK)
    want = e["jengine"].score_pairs_vtg_shared(e["jb"]["vtg"], e["cap"], e["vid"], ENGINE_TOPK)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.isfinite(got).all() and (got < 0).all()
    buckets = trerank.group_pairs_bucketed(e["vid"], e["cap"], ENGINE_TOPK)
    assert [(n, b, lo, hi, m) for n, b, lo, hi, m in t.pack_shards] == [
        ("vtg_shared", k, 0, len(g), len(g)) for k, g, _, _ in buckets]
    assert t.prefix_forwards == t.steps > len(buckets)


def test_compute_vtg_priors_matches_jax(engines):
    e = engines
    t = e["tengine"]
    t._prior_kv_cache = None
    t.prefix_forwards = t.steps = 0
    shards = list(t.pack_shards)
    got = t.compute_vtg_priors(e["tb"]["vtg"])
    want = e["jengine"].compute_vtg_priors(e["jb"]["vtg"])
    assert got.shape == (N,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # one prior prefix (memoized), one step a width bucket (64 captions a step)
    assert t.prefix_forwards == 1
    lens = e["tb"]["vtg"]["suffix_len_host"]
    per_bucket = np.unique([min(b for b in t.suffix_buckets if b >= L) for L in lens],
                           return_counts=True)[1]
    assert t.steps == sum(-(-c // PRIOR_BATCH) for c in per_bucket)
    assert t.pack_shards == shards       # not sharded


@pytest.mark.parametrize("with_prior", [False, True], ids=["scores", "with_prior"])
def test_score_pairs_tvg_shared_matches_jax(engines, with_prior):
    e = engines
    t = e["tengine"]
    t.prefix_forwards = t.steps = 0
    got, got_p = t.score_pairs_tvg_shared(e["tb"]["tvg"], e["tvocab"], e["cap"], e["vid"],
                                          ENGINE_TOPK, with_prior=with_prior)
    want, want_p = e["jengine"].score_pairs_tvg_shared(e["jb"]["tvg"], e["jvocab"], e["cap"],
                                                       e["vid"], ENGINE_TOPK, with_prior)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    if with_prior:
        np.testing.assert_allclose(got_p, want_p, atol=ATOL, rtol=RTOL)
        assert not np.allclose(got_p, got)
    else:
        assert got_p is None
    # a prefix forward a step, two with the prior
    assert t.prefix_forwards == (1 + with_prior) * t.steps > 0


def test_score_grids_shared_match_jax(engines):
    e = engines
    rows, cols = e["vid"], e["cap"]
    shape = (N, N)
    for name, args in (("score_grid_vtg_shared", ("vtg", ())),
                       ("score_grid_tvg_shared", ("tvg", ("vocab",)))):
        bank, extra = args
        targs = [e["tb"][bank]] + [e["tvocab"] for _ in extra]
        jargs = [e["jb"][bank]] + [e["jvocab"] for _ in extra]
        got = getattr(e["tengine"], name)(*targs, rows, cols, e["cap"], e["vid"], shape,
                                          with_prior=True, topk=ENGINE_TOPK)
        want = getattr(e["jengine"], name)(*jargs, rows, cols, e["cap"], e["vid"], shape,
                                           with_prior=True, topk=ENGINE_TOPK)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g == -100.0, np.asarray(w) == -100.0)
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


def test_stale_lora_refuses_the_rectangle(engines):
    e = engines
    t = e["tengine"]
    old = t.lora
    t.lora = {k: dict(v) for k, v in old.items()}
    try:
        with pytest.raises(AssertionError, match="stale"):
            t.score_pairs_tvg_shared(e["tb"]["tvg"], e["tvocab"], e["cap"], e["vid"],
                                     ENGINE_TOPK, with_prior=False)
    finally:
        t.lora = old


# ---------------------------------------------------------------------------
# the whole evaluation(packed=False)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rect(tokenizer):
    from blim_tpu.core.config import tiny_model_config as jax_tiny_config
    from blim_tpu.engine import evaluation as jeval
    from test_torch_distributed import _engine, _eval
    from test_torch_finetuned import trace_flops
    from test_torch_tvg import _lora_numpy

    jcfg = jax_tiny_config(vocab_size=152064, num_clips=4)
    jp = jvcf.init_params(jcfg, jax.random.key(0))
    lora_np = _lora_numpy(jcfg, 7)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal(
        (N, jcfg.num_clips, jcfg.tokens_per_clip, jcfg.mm_hidden_size)).astype(np.float32) * 0.5
    ev = {"feats": feats, "t2v": rng.standard_normal((N, N)).astype(np.float32) + 0.1,
          "v2t": rng.standard_normal((N, N)).astype(np.float32) + 0.1}
    inp = {"params": jax.tree_util.tree_map(np.asarray, jp), "lora": lora_np, "eval": ev}
    jvtg = jax_make_vtg_layout(tokenizer, "MSRVTT", jcfg.video_tokens_vtg, CAPS)
    jtvg = jax_make_tvg_layout(tokenizer, jcfg.num_clips, CAPS)
    mesh = make_mesh(devices=jax.devices()[:1])
    out = {}
    for flow, has_tvg in FLOWS.items():
        jengine = jrerank.RerankEngine(
            jp, jcfg, jvtg, jtvg, mesh,
            lora=jax.tree_util.tree_map(jnp.asarray, lora_np) if has_tvg else None,
            lora_scale=SCALE, prior_batch=PRIOR_BATCH)
        jlog = trace_flops(jengine)
        t2v, v2t = jeval.evaluation(
            jengine, jeval.EvalInputs(CAPTIONS, np.arange(N), feats, ev["t2v"], ev["v2t"]),
            tokenizer, "MSRVTT", topk=4, cpn=True, has_tvg=has_tvg, verbose=False,
            packed=False)
        out[flow, "jax"] = {"t2v": t2v, "v2t": v2t}
        out[flow, "packed"], _ = _eval(inp, has_tvg)
        engine, _ = _engine(inp, has_tvg)
        engine.prior_batch = PRIOR_BATCH
        tlog = trace_flops(engine)
        calls = {}
        for name in ("_vtg_shared_step", "_tvg_shared_step", "_vtg_prior_step"):
            def count(*a, _name=name, _real=getattr(engine, name), **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _real(*a, **k)
            setattr(engine, name, count)
        out[flow, "rect"], out[flow, "engine"] = _eval(inp, has_tvg, engine=engine, packed=False)
        out[flow, "calls"] = calls
        out[flow, "flops"] = (tlog, jlog, out[flow, "engine"], jengine)
    out["v2t_iv2"], out["t2v_iv2"] = ev["v2t"], ev["t2v"]
    return out


@pytest.mark.parametrize("flow,direction,name", CELLS, ids=CELL_IDS)
def test_rectangle_evaluation_matches_jax_and_packed(rect, flow, direction, name):
    t = rect[flow, "rect"][direction][name]
    j = rect[flow, "jax"][direction][name]
    packed = rect[flow, "packed"][direction][name]
    assert t.shape == j.shape == (N, N)
    np.testing.assert_array_equal(t == -100.0, j == -100.0)
    np.testing.assert_array_equal(t == -100.0, packed == -100.0)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(t, packed, atol=PACKED_TOL, rtol=PACKED_TOL)


@pytest.mark.parametrize("flow", list(FLOWS))
def test_rectangle_evaluation_keys_iv2_and_recall_match_jax(rect, flow):
    t, j = rect[flow, "rect"], rect[flow, "jax"]
    for direction in ("t2v", "v2t"):
        assert set(t[direction]) == set(j[direction])
        np.testing.assert_array_equal(t[direction]["internvideo2"], j[direction]["internvideo2"])
    ids = {i: i for i in range(N)}
    for cpn in (True, False):
        args = (ids, ids, (0.3, 0.8), (1.0, 0.5, 0.8, 0.6), cpn, FLOWS[flow])
        assert (tfusion.all_scoring_results(t["t2v"], t["v2t"], *args)
                == jfusion.all_scoring_results(j["t2v"], j["v2t"], *args))


@pytest.mark.parametrize("flow", list(FLOWS))
def test_rectangle_evaluation_prefix_forwards(rect, flow):
    """A prefix forward a VTG group step, one a TVG group step (two with
    the prior), one prior prefix; no packed TVG prefix, no naive forward."""
    engine, calls = rect[flow, "engine"], rect[flow, "calls"]
    vtg, tvg, prior = (calls.get(k, 0) for k in ("_vtg_shared_step", "_tvg_shared_step",
                                                 "_vtg_prior_step"))
    assert vtg > 0 and prior > 0 and (tvg > 0) == FLOWS[flow]
    assert engine.prefix_forwards == vtg + 2 * tvg + 1
    assert engine.steps == vtg + tvg + prior
    assert {s[0] for s in engine.pack_shards} == (
        {"vtg_shared", "tvg_shared"} if FLOWS[flow] else {"vtg_shared"})
    assert engine.tvg_prefix_forwards == engine.naive_forwards == 0


@pytest.mark.parametrize("flow", list(FLOWS))
def test_rectangle_flops_match_jax(rect, flow):
    """Each rectangle pass (VTG groups, the VTG priors, the TVG groups with
    their prior pass) adds JAX's dispatched and useful FLOPs."""
    from test_torch_finetuned import assert_flops_match

    tlog, jlog, engine, jengine = rect[flow, "flops"]
    want = {"score_pairs_vtg_shared", "compute_vtg_priors"} | (
        {"score_pairs_tvg_shared"} if FLOWS[flow] else set())
    assert {p for p, _, _ in tlog} == want
    assert_flops_match(tlog, jlog, engine, jengine)
