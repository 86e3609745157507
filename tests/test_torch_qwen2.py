"""The port's Qwen2 decoder against the JAX package's, at the tiny config
(2 layers, width 64, vocab 152064) in fp32 on the CPU, fed the same weights
through the bridge and the same numpy inputs. Tolerance: fp32 sums in
another order through two layers, atol 1e-5 / rtol 1e-4."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blim_tpu.core.config import tiny_model_config as jax_tiny_config
from blim_tpu.models import qwen2 as jq
from blim_tpu.models import videochat_flash as jvcf

from blim_tpu_torch.checkpoints.convert import params_from_numpy
from blim_tpu_torch.core.config import tiny_model_config
from blim_tpu_torch.models import qwen2 as tq

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL, RTOL = 1e-5, 1e-4
CFG = tiny_model_config(vocab_size=152064).llm
JCFG = jax_tiny_config(vocab_size=152064).llm


@pytest.fixture(scope="module")
def params():
    jp = jvcf.init_params(jax_tiny_config(vocab_size=152064), jax.random.key(0))["llm"]
    npp = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_numpy(npp, torch.float32, "cpu")


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


def _embeds(rng, b, s):
    return rng.standard_normal((b, s, CFG.hidden_size)).astype(np.float32) * 0.5


def _gapped_positions(b, s, gap_at=5, gap=40):
    pos = np.arange(s)
    pos[gap_at:] += gap  # the CPN prior prefix skips the video block
    return np.broadcast_to(pos, (b, s)).astype(np.int32).copy()


def test_rms_norm_matches(rng):
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    _close(tq.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
           jq.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))


@pytest.mark.parametrize("gapped", [False, True])
def test_rope_matches(rng, gapped):
    b, s, h, d = 2, 11, 3, 16
    pos = (_gapped_positions(b, s) if gapped
           else np.broadcast_to(np.arange(s), (b, s)).astype(np.int32).copy())
    tc, ts = tq.rope_cos_sin(torch.from_numpy(pos), d, CFG.rope_theta)
    jc, js = jq.rope_cos_sin(jnp.asarray(pos), d, JCFG.rope_theta)
    _close(tc, jc, atol=1e-5)
    _close(ts, js, atol=1e-5)
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    _close(tq.apply_rope(torch.from_numpy(x), tc, ts), jq.apply_rope(jnp.asarray(x), jc, js))


def test_embed_tokens_matches(params, rng):
    jp, tp = params
    ids = rng.integers(0, CFG.vocab_size, (2, 9)).astype(np.int32)
    _close(tq.embed_tokens(tp, torch.from_numpy(ids)), jq.embed_tokens(jp, jnp.asarray(ids)),
           atol=0, rtol=0)


@pytest.mark.parametrize("mask_kind", ["none", "holes"])
def test_forward_hidden_matches(params, rng, mask_kind):
    jp, tp = params
    b, s = 2, 19
    emb = _embeds(rng, b, s)
    mask = None
    if mask_kind == "holes":
        mask = np.ones((b, s), np.int32)
        mask[:, 4:9] = 0      # a CPN-masked block
        mask[1, -3:] = 0      # right padding
    j = jq.forward_hidden(jp, JCFG, jnp.asarray(emb),
                          None if mask is None else jnp.asarray(mask), use_pallas=False)
    t = tq.forward_hidden(tp, CFG, torch.from_numpy(emb),
                          None if mask is None else torch.from_numpy(mask))
    _close(t, j)


def test_forward_collect_kv_matches(params, rng):
    jp, tp = params
    b, s = 2, 17
    emb = _embeds(rng, b, s)
    mask = np.ones((b, s), np.int32)
    mask[0, -4:] = 0
    pos = _gapped_positions(b, s)
    jh, jkv = jq.forward_collect_kv(jp, JCFG, jnp.asarray(emb), jnp.asarray(mask),
                                    jnp.asarray(pos), use_pallas=False)
    th, tkv = tq.forward_collect_kv(tp, CFG, torch.from_numpy(emb), torch.from_numpy(mask),
                                    torch.from_numpy(pos))
    _close(th, jh)
    for key in ("k", "v"):
        assert tuple(tkv[key].shape) == (CFG.num_hidden_layers, b, s,
                                         CFG.num_key_value_heads, CFG.head_dim)
        _close(tkv[key], jkv[key])


def _pack(seg_lens, t, p_len):
    seg = np.full(t, -1, np.int32)
    pos = np.zeros(t, np.int32)
    o = 0
    for i, L in enumerate(seg_lens):
        seg[o:o + L] = i
        pos[o:o + L] = p_len + np.arange(L)
        o += L
    return seg, pos


@pytest.mark.parametrize("t,seg_lens", [
    (40, [(7, 12, 9), (5, 3, 11, 2)]),
    (384, [(100, 90, 120), (7, 300)]),   # T > 256, T % 128 == 0: JAX tiles the queries
], ids=["short", "tiled"])
def test_forward_packed_suffix_matches(params, rng, t, seg_lens):
    jp, tp = params
    g, p_len = 2, 20
    prefix = _embeds(rng, g, p_len)
    pmask = np.ones((g, p_len), np.int32)
    pmask[1, 3:6] = 0
    _, kv = jq.forward_collect_kv(jp, JCFG, jnp.asarray(prefix), jnp.asarray(pmask),
                                  use_pallas=False)
    kv_np = {k: np.array(v) for k, v in kv.items()}
    seg, pos = zip(*(_pack(lens, t, p_len) for lens in seg_lens))
    seg, pos = np.stack(seg), np.stack(pos)
    suffix = _embeds(rng, g, t)
    j = jq.forward_packed_suffix(jp, JCFG, jnp.asarray(suffix), kv, jnp.asarray(seg),
                                 jnp.asarray(pos), prefix_mask=jnp.asarray(pmask))
    tt = tq.forward_packed_suffix(tp, CFG, torch.from_numpy(suffix),
                                  {k: torch.from_numpy(v) for k, v in kv_np.items()},
                                  torch.from_numpy(seg), torch.from_numpy(pos),
                                  prefix_mask=torch.from_numpy(pmask))
    _close(tt, j)


def test_packed_prefix_attention_matches(rng):
    g, t, p_len, hq, hkv, hd = 2, 30, 9, 4, 2, 16
    q = rng.standard_normal((g, t, hq, hd)).astype(np.float32)
    ks, vs = (rng.standard_normal((g, t, hkv, hd)).astype(np.float32) for _ in range(2))
    kp, vp = (rng.standard_normal((g, p_len, hkv, hd)).astype(np.float32) for _ in range(2))
    seg = np.stack([_pack((10, 8, 5), t, p_len)[0], _pack((3, 20), t, p_len)[0]])
    pmask = np.ones((g, p_len), np.int32)
    pmask[0, :2] = 0
    j = jq._packed_prefix_attention(*(jnp.asarray(a) for a in (q, ks, vs, kp, vp, seg)),
                                    hd ** -0.5, prefix_mask=jnp.asarray(pmask))
    tt = tq._packed_prefix_attention(*(torch.from_numpy(a) for a in (q, ks, vs, kp, vp, seg)),
                                     hd ** -0.5, prefix_mask=torch.from_numpy(pmask))
    _close(tt, j)
    assert not tt.numpy()[seg < 0].any()  # padding emits zeros


def test_lm_logits_matches(params, rng):
    jp, tp = params
    h = _embeds(rng, 2, 5)
    t = tq.lm_logits(tp, torch.from_numpy(h), CFG)
    assert t.dtype == torch.float32 and tuple(t.shape) == (2, 5, CFG.vocab_size)
    _close(t, jq.lm_logits(jp, jnp.asarray(h), JCFG))


def test_logits_match_hf_transformers_qwen2(rng):
    """The port's decoder + LM head against HF transformers' Qwen2 (the
    reference model family), on an HF state dict mapped to the shared tree
    layout by the JAX package's converter."""
    from transformers import Qwen2Config as HFConfig
    from transformers.models.qwen2 import Qwen2ForCausalLM

    from blim_tpu.checkpoints.convert import convert_qwen2
    from blim_tpu.core.config import Qwen2Config as JaxQwen2Config

    from blim_tpu_torch.core.config import Qwen2Config

    torch.manual_seed(0)
    dims = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
                rope_theta=1_000_000.0)
    hf = Qwen2ForCausalLM(HFConfig(rms_norm_eps=1e-6, tie_word_embeddings=False,
                                   attn_implementation="eager", **dims)).eval()
    tree = convert_qwen2(hf.state_dict(), JaxQwen2Config(head_dim=16, **dims))
    tp = params_from_numpy(tree, torch.float32, "cpu")
    cfg = Qwen2Config(head_dim=16, **dims)
    ids = rng.integers(0, 256, size=(2, 24))
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids), attention_mask=torch.ones(2, 24)).logits
        hidden = tq.forward_hidden(tp, cfg, tq.embed_tokens(tp, torch.tensor(ids)))
        got = tq.lm_logits(tp, hidden, cfg)
    np.testing.assert_allclose(got.numpy(), want.float().numpy(), atol=1e-4, rtol=1e-4)


def test_forward_hidden_sliding_window_matches(params, rng):
    """Sliding window (dormant in BLiM configs) below max_window_layers, on
    the plain path: the port's per-layer windows match the JAX package's."""
    import dataclasses

    jp, tp = params
    win = dict(use_sliding_window=True, sliding_window=4, max_window_layers=1)
    jcfg, tcfg = dataclasses.replace(JCFG, **win), dataclasses.replace(CFG, **win)
    emb = _embeds(rng, 2, 13)
    j = jq.forward_hidden(jp, jcfg, jnp.asarray(emb), use_pallas=False)
    t = tq.forward_hidden(tp, tcfg, torch.from_numpy(emb))
    _close(t, j)
    assert not np.allclose(t.numpy(), tq.forward_hidden(tp, CFG, torch.from_numpy(emb)).numpy())
