"""The port's TVG (fine-tuned direction) model surface against the JAX
package's, and the port's packed TVG scores against its own naive
full-sequence scores.

Tiny config (2 layers, width 64, 4 heads over 2 K/V heads, vocab 152064,
4 clips), fp32 on the CPU, weights and a LoRA tree (r 8, alpha 32, B
factors made non-zero so the adapters act) bridged from the JAX trees, inputs
from numpy seeds. Tolerance against JAX: atol 1e-4 / rtol 1e-4 (fp32 through
two layers, both sides in the same order of operations up to the BLAS
blocking). Packed against naive: atol 3e-4 / rtol 3e-4, as the JAX package
holds its own packed path (tests/test_shared_prefix_tvg.py): the packed
path runs each caption's prefix at another row width and its suffix against
the prefix K/V instead of in one sequence, so the sums run in another order.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blim_tpu.adapters import lora as jlora
from blim_tpu.core.config import tiny_model_config as jax_tiny_config
from blim_tpu.data.prompts import make_tvg_layout as jax_make_tvg_layout
from blim_tpu.engine.rerank import CaptionBank as JaxCaptionBank
from blim_tpu.models import qwen2 as jqwen2
from blim_tpu.models import videochat_flash as jvcf

from blim_tpu_torch.adapters.lora import LoraConfig
from blim_tpu_torch.checkpoints.convert import params_from_numpy
from blim_tpu_torch.core.config import tiny_model_config
from blim_tpu_torch.data.prompts import make_tvg_layout, make_vtg_layout
from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
from blim_tpu_torch.engine.rerank import CaptionBank, RerankEngine, topk_pairs
from blim_tpu_torch.models import qwen2 as tqwen2
from blim_tpu_torch.models import videochat_flash as tvcf

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = RTOL = 1e-4
PACKED_TOL = 3e-4
SCALE = LoraConfig().scale
N, TOPK = 6, 3
CAPTIONS = [   # the first two have the same token length: the prior dedup merges them
    "a cat sits on a mat",
    "a man rides a horse",
    "children play soccer",
    "a chef cooks pasta",
    "a dog catches a frisbee",
    "two people dance",
]


def _lora_numpy(jcfg, seed):
    """The JAX LoRA tree with its zero B factors replaced by small seeded
    values, as numpy."""
    lcfg = jlora.LoraConfig()
    tree = {"llm": jlora.init_llm_lora(jax.random.key(seed), jcfg.llm, lcfg),
            "projector": jlora.init_projector_lora(jax.random.key(seed + 1), jcfg.mm_hidden_size,
                                                   jcfg.llm.hidden_size, lcfg)}
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: (rng.standard_normal(np.shape(v)).astype(np.float32) * 0.02
                        if k == "b" else fill(v)) for k, v in node.items()}
        return np.asarray(node, np.float32)

    return fill(tree)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny_config(vocab_size=152064, num_clips=4)
    tcfg = tiny_model_config(vocab_size=152064, num_clips=4)
    jp = jvcf.init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), torch.float32, "cpu")
    lora_np = _lora_numpy(jcfg, 3)
    jl = jax.tree_util.tree_map(jnp.asarray, lora_np)
    tl = params_from_numpy(lora_np, torch.float32, "cpu")
    return jcfg, tcfg, jp, tp, jl, tl


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


def _randn(rng, *shape, scale=1.0):
    return rng.standard_normal(shape).astype(np.float32) * scale


# segment 1 of row 0 is one token long; both rows end in padding
SEG_IDS = np.array([[0, 0, 0, 1, 2, 2, 2, 2, -1, -1],
                    [0, 0, 1, 1, 1, 1, 1, 1, 1, -1]], np.int32)


def _pack_positions(seg_ids, p_full):
    """Each segment's tokens at P_full - L + j, as the packed TVG prefixes."""
    pos = np.zeros(seg_ids.shape, np.int32)
    for g, row in enumerate(seg_ids):
        for s in set(row[row >= 0].tolist()):
            idx = np.nonzero(row == s)[0]
            pos[g, idx] = p_full - len(idx) + np.arange(len(idx))
    return pos


def test_packed_self_attention_matches_jax():
    rng = np.random.default_rng(0)
    g, t, hq, hkv, hd = 2, SEG_IDS.shape[1], 4, 2, 16
    q, k, v = _randn(rng, g, t, hq, hd), _randn(rng, g, t, hkv, hd), _randn(rng, g, t, hkv, hd)
    got = tqwen2._packed_self_attention(_t(q), _t(k), _t(v), _t(SEG_IDS), hd ** -0.5)
    want = jqwen2._packed_self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(SEG_IDS), hd ** -0.5)
    _close(got, want)
    assert torch.isfinite(got).all()
    assert (got[torch.from_numpy(SEG_IDS < 0)] == 0).all()
    # the one-token segment sees only itself: its output is its own value row
    _close(got[0, 3].reshape(hkv, hq // hkv, hd)[:, 0], v[0, 3])


def test_forward_collect_kv_packed_matches_jax(setup):
    jcfg, tcfg, jp, tp, jl, tl = setup
    rng = np.random.default_rng(1)
    emb = _randn(rng, *SEG_IDS.shape, tcfg.llm.hidden_size, scale=0.5)
    pos = _pack_positions(SEG_IDS, 40)
    assert not (pos == np.arange(pos.shape[1])).all()
    th, tkv = tqwen2.forward_collect_kv_packed(tp["llm"], tcfg.llm, _t(emb), _t(SEG_IDS), _t(pos),
                                               lora=tl["llm"], lora_scale=SCALE)
    jh, jkv = jqwen2.forward_collect_kv_packed(jp["llm"], jcfg.llm, jnp.asarray(emb),
                                               jnp.asarray(SEG_IDS), jnp.asarray(pos),
                                               lora=jl["llm"], lora_scale=SCALE)
    _close(th, jh)
    for key in ("k", "v"):
        assert tuple(tkv[key].shape) == (2, *SEG_IDS.shape, 2, 16)
        _close(tkv[key], jkv[key])


def _grouped_inputs(rng, mask_dims):
    g, kk, w, hq, hkv, hd, p = 2, 3, 4, 4, 2, 16, 9
    q = _randn(rng, g, kk, w, hq, hd)
    k_suf, v_suf = _randn(rng, g, kk, w, hkv, hd), _randn(rng, g, kk, w, hkv, hd)
    k_pre, v_pre = _randn(rng, g, p, hkv, hd), _randn(rng, g, p, hkv, hd)
    suffix_mask = np.ones((g, kk, w), np.int32)
    suffix_mask[0, 2] = 0           # an unused query slot
    suffix_mask[1, :, 0] = 0        # the CPN prior's masked column 0
    shape = (g, p) if mask_dims == 2 else (g, kk, p)
    prefix_mask = (rng.random(shape) < 0.6).astype(np.int32)
    prefix_mask[..., 0] = 1
    if mask_dims == 3:
        prefix_mask[0, 2] = 0       # the unused slot sees no prefix key either
    return q, k_suf, v_suf, k_pre, v_pre, suffix_mask, prefix_mask


@pytest.mark.parametrize("mask_dims", [2, 3])
def test_grouped_prefix_attention_matches_jax(mask_dims):
    args = _grouped_inputs(np.random.default_rng(mask_dims), mask_dims)
    scale = 16 ** -0.5
    *front, suffix_mask, prefix_mask = args
    got = tqwen2._grouped_prefix_attention(*map(_t, front), _t(suffix_mask), scale,
                                           prefix_mask=_t(prefix_mask))
    want = jqwen2._grouped_prefix_attention(*map(jnp.asarray, front), jnp.asarray(suffix_mask),
                                            scale, prefix_mask=jnp.asarray(prefix_mask))
    _close(got, want)
    assert torch.isfinite(got).all()
    assert (got[0, 2] == 0).all()        # the all-masked query slot emits zeros
    assert (got[1, :, 0] == 0).all()


def test_forward_suffix_with_prefix_matches_jax(setup):
    jcfg, tcfg, jp, tp, jl, tl = setup
    rng = np.random.default_rng(4)
    g, kk, w, d, p = 2, 3, 4, tcfg.llm.hidden_size, 9
    emb = _randn(rng, g, kk, w, d, scale=0.5)
    kv = {key: _randn(rng, 2, g, p, 2, 16) for key in ("k", "v")}
    _, _, _, _, _, suffix_mask, prefix_mask = _grouped_inputs(rng, 3)
    got = tqwen2.forward_suffix_with_prefix(
        tp["llm"], tcfg.llm, _t(emb), {k: _t(v) for k, v in kv.items()}, _t(suffix_mask), 37,
        prefix_mask=_t(prefix_mask), lora=tl["llm"], lora_scale=SCALE)
    want = jqwen2.forward_suffix_with_prefix(
        jp["llm"], jcfg.llm, jnp.asarray(emb), jax.tree_util.tree_map(jnp.asarray, kv),
        jnp.asarray(suffix_mask), 37, prefix_mask=jnp.asarray(prefix_mask), lora=jl["llm"],
        lora_scale=SCALE)
    assert tuple(got.shape) == (g, kk, w, d)
    _close(got, want)


def _pack(rng):
    ids = rng.integers(0, 152064, SEG_IDS.shape).astype(np.int32)
    return ids, SEG_IDS, _pack_positions(SEG_IDS, 40)


def test_tvg_pack_prefix_kv_matches_jax(setup):
    jcfg, tcfg, jp, tp, jl, tl = setup
    ids, seg, pos = _pack(np.random.default_rng(5))
    got = tvcf.tvg_pack_prefix_kv(tp, tcfg, _t(ids), _t(seg), _t(pos), lora=tl, lora_scale=SCALE)
    want = jvcf.tvg_pack_prefix_kv(jp, jcfg, jnp.asarray(ids), jnp.asarray(seg),
                                   jnp.asarray(pos), lora=jl, lora_scale=SCALE)
    for key in ("k", "v"):
        _close(got[key], want[key])


@pytest.mark.parametrize("cpn", [False, True])
def test_score_tvg_packed_matches_jax(setup, cpn):
    jcfg, tcfg, jp, tp, jl, tl = setup
    rng = np.random.default_rng(6)
    ids, seg, pos = _pack(rng)
    jkv = jvcf.tvg_pack_prefix_kv(jp, jcfg, jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(pos),
                                  lora=jl, lora_scale=SCALE)
    q_seg = np.array([[0, 0, 1, 2, 2, -1], [1, 1, 1, 0, -1, -1]], np.int32)
    q_first = rng.integers(0, 152064, q_seg.shape).astype(np.int32)
    q_video = _randn(rng, *q_seg.shape, tcfg.num_clips, tcfg.llm.hidden_size, scale=0.5)
    vocab = _randn(rng, 7, tcfg.num_clips, tcfg.mm_hidden_size)
    q_label = rng.integers(0, 7, q_seg.shape).astype(np.int32)
    got = tvcf.score_tvg_packed(tp, tcfg, {k: _t(np.array(v)) for k, v in jkv.items()},
                                _t(seg), _t(q_seg), _t(q_first), _t(q_video), _t(q_label),
                                _t(vocab), 40, cpn=cpn, lora=tl, lora_scale=SCALE)
    want = jvcf.score_tvg_packed(jp, jcfg, jkv, jnp.asarray(seg), jnp.asarray(q_seg),
                                 jnp.asarray(q_first), jnp.asarray(q_video), jnp.asarray(q_label),
                                 jnp.asarray(vocab), 40, cpn=cpn, lora=jl, lora_scale=SCALE)
    assert tuple(got.shape) == q_seg.shape
    _close(got, want)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("cpn", [False, True])
def test_score_tvg_matches_jax(setup, tokenizer, cpn):
    jcfg, tcfg, jp, tp, jl, tl = setup
    rng = np.random.default_rng(7)
    layout = jax_make_tvg_layout(tokenizer, jcfg.num_clips, max_caption_tokens=24)
    bank = JaxCaptionBank.build_tvg(CAPTIONS[:4], tokenizer, layout)
    feats = _randn(rng, 4, tcfg.num_clips, tcfg.tokens_per_clip, tcfg.mm_hidden_size, scale=0.5)
    vocab = feats.mean(axis=-2)
    batch = {"input_ids": bank.input_ids, "attention_mask": bank.attention_mask,
             "cpn_mask": bank.cpn_mask, "video": feats,
             "video_label": np.array([2, 0, 3, 1], np.int32)}
    gather = int(layout.gather_positions[0])
    got = tvcf.score_tvg(tp, tcfg, {k: _t(v) for k, v in batch.items()}, _t(vocab),
                         layout.video_start, gather, cpn=cpn, lora=tl, lora_scale=SCALE)
    want = jvcf.score_tvg(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                          jnp.asarray(vocab), layout.video_start, gather, cpn=cpn, lora=jl,
                          lora_scale=SCALE)
    _close(got, want)


# -- the port's packed engine path against its own naive path -----------------

@pytest.fixture(scope="module")
def engine_setup(setup):
    _, tcfg, _, tp, _, tl = setup
    tok = ByteFallbackTokenizer()
    vtg = make_vtg_layout(tok, "MSRVTT", tcfg.video_tokens_vtg, max_caption_tokens=24)
    tvg = make_tvg_layout(tok, tcfg.num_clips, max_caption_tokens=24)
    engine = RerankEngine(tp, tcfg, vtg, tvg, lora=tl, lora_scale=SCALE, device="cpu")
    feats = _randn(np.random.default_rng(1), N, tcfg.num_clips, tcfg.tokens_per_clip,
                   tcfg.mm_hidden_size, scale=0.5)
    bank = CaptionBank.build_tvg(CAPTIONS, tok, tvg)
    banks = engine.upload(bank, feats)
    vocab = engine.video_vocab(banks)
    rows, cols = topk_pairs(np.random.default_rng(2).standard_normal((N, N)), TOPK)
    return engine, bank, banks, feats, vocab, rows, cols


def _naive(engine, bank, feats, vocab, cap_idx, vid_idx, cpn):
    lay = engine.tvg_layout
    batch = {"input_ids": _t(bank.input_ids[cap_idx]),
             "attention_mask": _t(bank.attention_mask[cap_idx]),
             "cpn_mask": _t(bank.cpn_mask[cap_idx]), "video": _t(feats[vid_idx]),
             "video_label": _t(vid_idx)}
    with torch.no_grad():
        out = tvcf.score_tvg(engine.params, engine.config, batch, vocab, lay.video_start,
                             int(lay.gather_positions[0]), cpn=cpn, lora=engine.lora,
                             lora_scale=engine.lora_scale)
    return out.numpy()


def test_tvg_packed_matches_naive(engine_setup):
    """t2v direction (caption = row, video = column), likelihood and prior."""
    engine, bank, banks, feats, vocab, rows, cols = engine_setup
    scores, priors = engine.score_pairs_tvg_packed(banks, vocab, rows, cols, with_prior=True)
    np.testing.assert_allclose(scores, _naive(engine, bank, feats, vocab, rows, cols, False),
                               atol=PACKED_TOL, rtol=PACKED_TOL)
    np.testing.assert_allclose(priors, _naive(engine, bank, feats, vocab, rows, cols, True),
                               atol=PACKED_TOL, rtol=PACKED_TOL)
    assert engine.tvg_prefix_forwards > 0


def test_tvg_packed_v2t_direction(engine_setup):
    """v2t direction: caption = column, video = row."""
    engine, bank, banks, feats, vocab, rows, cols = engine_setup
    scores, priors = engine.score_pairs_tvg_packed(banks, vocab, cols, rows, with_prior=False)
    assert priors is None
    np.testing.assert_allclose(scores, _naive(engine, bank, feats, vocab, cols, rows, False),
                               atol=PACKED_TOL, rtol=PACKED_TOL)


def test_tvg_prior_dedup_shares_one_prior_per_length(engine_setup):
    """prior(c, v) == prior(len(c), v): the prior pass scores one caption per
    (length, video), so captions 0 and 1 (one token length) get the same
    prior bit for bit, and each is its own naive prior within PACKED_TOL."""
    engine, bank, banks, feats, vocab, rows, cols = engine_setup
    lens = banks["prefix_len_host"]
    assert lens[0] == lens[1] and len(np.unique(lens)) < N
    cap = np.repeat([0, 1], N)
    vid = np.tile(np.arange(N), 2)
    _, priors = engine.score_pairs_tvg_packed(banks, vocab, cap, vid, with_prior=True)
    np.testing.assert_array_equal(priors[:N], priors[N:])
    np.testing.assert_allclose(priors, _naive(engine, bank, feats, vocab, cap, vid, True),
                               atol=PACKED_TOL, rtol=PACKED_TOL)
