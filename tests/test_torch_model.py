"""The port's VTG model surface against the JAX package's (projector,
splice, prefix K/V, packed scoring, naive scoring), and the port's packed
shared-prefix scores against its own naive full-sequence scores. Tiny
config (2 layers, width 64, vocab 152064), fp32 on the CPU; tolerance atol
1e-5 / rtol 1e-4 against JAX, 1e-4 for packed against naive."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blim_tpu.core.config import tiny_model_config as jax_tiny_config
from blim_tpu.models import projector as jproj
from blim_tpu.models import videochat_flash as jvcf

from blim_tpu_torch.checkpoints.convert import params_from_numpy
from blim_tpu_torch.core.config import tiny_model_config
from blim_tpu_torch.data.prompts import make_vtg_layout
from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
from blim_tpu_torch.engine.rerank import CaptionBank, RerankEngine, build_packs
from blim_tpu_torch.models import projector as tproj
from blim_tpu_torch.models import videochat_flash as tvcf

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL, RTOL = 1e-5, 1e-4
CAPTIONS = ["a cat sits on a mat", "a man rides a horse through a field",
            "children play soccer", "a chef cooks pasta in a kitchen", "a dog catches a frisbee"]
N = len(CAPTIONS)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny_config(vocab_size=152064)
    tcfg = tiny_model_config(vocab_size=152064)
    jp = jvcf.init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), torch.float32, "cpu")
    feats = np.random.default_rng(1).standard_normal(
        (N, tcfg.num_clips, tcfg.tokens_per_clip, tcfg.mm_hidden_size)).astype(np.float32) * 0.5
    layout = make_vtg_layout(ByteFallbackTokenizer(), "MSRVTT", tcfg.video_tokens_vtg,
                             max_caption_tokens=24)
    return jcfg, tcfg, jp, tp, feats, layout


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


def test_mlp_and_project_vtg_match(setup):
    jcfg, tcfg, jp, tp, feats, _ = setup
    _close(tproj.mlp_apply(tp["projector"]["mlp"], _t(feats[0])),
           jproj.mlp_apply(jp["projector"]["mlp"], jnp.asarray(feats[0])))
    out = tproj.project_vtg(tp["projector"], _t(feats[:2]))
    assert tuple(out.shape) == (2, tcfg.video_tokens_vtg, tcfg.llm.hidden_size)
    _close(out, jproj.project_vtg(jp["projector"], jnp.asarray(feats[:2])))


def test_splice_video_matches(rng):
    tok = rng.standard_normal((2, 20, 8)).astype(np.float32)
    vid = rng.standard_normal((2, 6, 8)).astype(np.float32)
    _close(tvcf.splice_video(_t(tok), _t(vid), 5),
           jvcf.splice_video(jnp.asarray(tok), jnp.asarray(vid), 5), atol=0, rtol=0)


def test_vtg_text_prefix_kv_matches(setup):
    jcfg, tcfg, jp, tp, _, layout = setup
    ids, pos = layout.prior_prefix()
    assert (np.diff(pos) > 1).any()  # gapped positions
    mask = np.ones((1, len(ids)), np.int32)
    j = jvcf.vtg_text_prefix_kv(jp, jcfg, jnp.asarray(ids)[None], jnp.asarray(pos)[None],
                                jnp.asarray(mask), use_pallas=False)
    t = tvcf.vtg_text_prefix_kv(tp, tcfg, _t(ids)[None], _t(pos)[None], _t(mask))
    for key in ("k", "v"):
        _close(t[key], j[key])


def test_vtg_prefix_hidden_kv_matches(setup):
    jcfg, tcfg, jp, tp, feats, layout = setup
    ids = np.broadcast_to(layout.prefix_token_ids(), (2, layout.prefix_len)).copy()
    j = jvcf.vtg_prefix_hidden_kv(jp, jcfg, jnp.asarray(ids), jnp.asarray(feats[:2]),
                                  layout.video_start, use_pallas=False)
    t = tvcf.vtg_prefix_hidden_kv(tp, tcfg, _t(ids), _t(feats[:2]), layout.video_start)
    for key in ("k", "v"):
        _close(t[key], j[key])


def _engine_and_banks(setup):
    _, tcfg, _, tp, feats, layout = setup
    engine = RerankEngine(tp, tcfg, layout, device="cpu")
    bank = CaptionBank.build_vtg(CAPTIONS, ByteFallbackTokenizer(), "MSRVTT", layout)
    return engine, bank, engine.upload(bank, feats)


def test_score_vtg_packed_matches(setup):
    jcfg, tcfg, jp, tp, feats, layout = setup
    engine, _, banks = _engine_and_banks(setup)
    vid = np.array([0, 0, 0, 1, 1, 3])
    cap = np.array([0, 2, 4, 1, 3, 2])
    (size, packs), = build_packs(vid, cap, banks["suffix_len_host"], (128,))
    ids, seg, pos, lab = engine._assemble_packs_bulk(banks, packs, size)
    assert (seg.max(axis=1) >= 2).any()  # a pack of three segments
    vids = np.array([key for key, _, _ in packs])
    prefix = np.broadcast_to(layout.prefix_token_ids(), (len(packs), layout.prefix_len)).copy()
    jkv = jvcf.vtg_prefix_hidden_kv(jp, jcfg, jnp.asarray(prefix), jnp.asarray(feats[vids]),
                                    layout.video_start, use_pallas=False)
    tkv = tvcf.vtg_prefix_hidden_kv(tp, tcfg, _t(prefix), _t(feats[vids]), layout.video_start)
    j = jvcf.score_vtg_packed(jp, jcfg, jkv, *(jnp.asarray(a) for a in (ids, seg, pos, lab)),
                              size // 4)
    t = tvcf.score_vtg_packed(tp, tcfg, tkv, *(_t(a) for a in (ids, seg, pos, lab)), size // 4)
    assert tuple(t.shape) == (len(packs), size // 4)
    _close(t, j)


def _naive_batch(bank, feats, caps, vids):
    return {
        "input_ids": _t(bank.input_ids[caps]),
        "attention_mask": _t(bank.attention_mask[caps]),
        "cpn_mask": _t(bank.cpn_mask[caps]),
        "window_labels": _t(bank.window_labels[caps]),
        "video": _t(feats[vids]),
    }


@pytest.mark.parametrize("cpn", [False, True])
def test_score_vtg_naive_matches(setup, cpn):
    jcfg, tcfg, jp, tp, feats, layout = setup
    _, bank, _ = _engine_and_banks(setup)
    caps, vids = np.array([0, 3, 4]), np.array([1, 1, 2])
    batch = _naive_batch(bank, feats, caps, vids)
    ws, wl = layout.label_window
    t = tvcf.score_vtg(tp, tcfg, batch, layout.video_start, ws, wl, cpn=cpn)
    j = jvcf.score_vtg(jp, jcfg, {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                       layout.video_start, ws, wl, cpn=cpn, use_pallas=False)
    _close(t, j)


def test_packed_matches_naive_in_the_port(setup):
    """Shared-prefix packed scores and packed CPN priors equal the naive
    full-sequence path inside the port."""
    _, tcfg, _, tp, feats, layout = setup
    engine, bank, banks = _engine_and_banks(setup)
    rng = np.random.default_rng(4)
    vid = rng.integers(0, N, 14)
    cap = rng.integers(0, N, 14)
    packed = engine.score_pairs_vtg_packed(banks, cap, vid)
    priors = engine.compute_vtg_priors_packed(banks)
    ws, wl = layout.label_window
    batch = _naive_batch(bank, feats, cap, vid)
    naive = tvcf.score_vtg(tp, tcfg, batch, layout.video_start, ws, wl)
    np.testing.assert_allclose(packed, naive.numpy(), atol=1e-4, rtol=1e-4)
    all_caps = np.arange(N)
    naive_prior = tvcf.score_vtg(tp, tcfg, _naive_batch(bank, feats, all_caps, all_caps),
                                 layout.video_start, ws, wl, cpn=True)
    np.testing.assert_allclose(priors, naive_prior.numpy(), atol=1e-4, rtol=1e-4)
    # the prior is video-independent: another video in the masked block changes nothing
    other = tvcf.score_vtg(tp, tcfg, _naive_batch(bank, feats, all_caps, (all_caps + 1) % N),
                           layout.video_start, ws, wl, cpn=True)
    np.testing.assert_allclose(other.numpy(), naive_prior.numpy(), atol=1e-5, rtol=1e-5)
    # prefix forwards: one per video-prefix step plus one prior prefix
    assert engine.prefix_forwards == engine.steps - _prior_steps(engine, banks) + 1


def _prior_steps(engine, banks):
    """Steps the prior pass takes for this bank (batch_plan over its packs)."""
    from blim_tpu_torch.engine.rerank import batch_plan, packs_per_step

    n = banks["n_captions"]
    P = len(engine.vtg_layout.prior_prefix()[0])
    steps = 0
    for size, packs in build_packs(np.zeros(n, np.int64), np.arange(n),
                                   banks["suffix_len_host"], engine.pack_sizes):
        steps += len(batch_plan(len(packs), packs_per_step(P, size)))
    return steps
