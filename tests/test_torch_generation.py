"""The port's KV-cache generation (blim_tpu_torch/models/generation.py)
against the JAX package's, at the tiny config (2 layers, width 64, vocab
512) in fp32 on the CPU, fed the same weights through the bridge.

Greedy tokens must be equal exactly; the per-step logits of the cached
decode must match the JAX package's full-sequence forward over the
generated tokens (teacher forcing) within atol 1e-4 (fp32 through two
layers, logits of order 0.1-1). Sampling cannot be matched to jax.random
bit for bit, so it is checked on its own terms: one torch.Generator seed
gives one sequence, and only tokens of non-zero probability are drawn."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blim_tpu.adapters import lora as jlora
from blim_tpu.core.config import tiny_model_config as jax_tiny_config
from blim_tpu.models import generation as jgen
from blim_tpu.models import qwen2 as jq
from blim_tpu.models import videochat_flash as jvcf

from blim_tpu_torch.checkpoints.convert import params_from_numpy
from blim_tpu_torch.core.config import tiny_model_config
from blim_tpu_torch.kernels import flash_attention as tfa
from blim_tpu_torch.models import generation as tgen
from blim_tpu_torch.models import qwen2 as tq

torch.backends.cuda.matmul.allow_tf32 = False

CFG = tiny_model_config().llm
JCFG = jax_tiny_config().llm
NO_EOS = [999]            # outside the 512-token vocabulary: generation never stops
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The decode loop is thousands of tiny ops: one intra-op thread keeps
    them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    jp = jvcf.init_params(jax_tiny_config(), jax.random.key(0))["llm"]
    rng = np.random.default_rng(7)
    # seeded noise on every leaf: norms and biases away from 1 and 0, wider logits
    npp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), jp)
    return jax.tree_util.tree_map(jnp.asarray, npp), params_from_numpy(npp, torch.float32, "cpu")


@pytest.fixture(scope="module")
def lora():
    """The JAX LoRA tree with its zero B factors seeded off zero, so the
    adapters change the output."""
    lcfg = jlora.LoraConfig(r=4, alpha=8)
    tree = jlora.init_llm_lora(jax.random.key(3), JCFG, lcfg)
    rng = np.random.default_rng(4)

    def fill(node):
        if isinstance(node, dict):
            return {k: (rng.standard_normal(np.shape(v)).astype(np.float32) * 0.05
                        if k == "b" else fill(v)) for k, v in node.items()}
        return np.asarray(node, np.float32)

    npl = fill(tree)
    return (jax.tree_util.tree_map(jnp.asarray, npl), params_from_numpy(npl, torch.float32, "cpu"),
            lcfg.scale)


def _port(params, ids, mask, n, eos=NO_EOS, tlora=None, scale=0.0):
    """The port's (tokens, per-step logits) for a prompt."""
    _, tp = params
    tt, logits = tgen.generate_tokens(
        tp, CFG, tq.embed_tokens(tp, torch.from_numpy(ids)), torch.from_numpy(mask), n, eos,
        lora=tlora, lora_scale=scale, return_logits=True)
    return tt.numpy(), logits


def _both(params, ids, mask, n, eos=NO_EOS, jlora_=None, tlora=None, scale=0.0):
    """(JAX tokens, port tokens, port per-step logits) for the same prompt."""
    jp, _ = params
    jt = np.asarray(jgen.generate_tokens(
        jp, JCFG, jq.embed_tokens(jp, jnp.asarray(ids)), jnp.asarray(mask), n, eos,
        lora=jlora_, lora_scale=scale))
    return (jt, *_port(params, ids, mask, n, eos, tlora, scale))


def _ids(rng, b, s):
    return rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int64)


@pytest.mark.parametrize("b,s,n", [(1, 10, 8), (2, 7, 6), (1, 1, 5)])
def test_greedy_tokens_match_jax(params, rng, b, s, n):
    ids = _ids(rng, b, s)
    tfa.reset_counts()
    jt, tt, _ = _both(params, ids, np.ones((b, s), np.int64), n)
    assert not any(tfa.counts().values())          # the CPU runs the plain attention
    assert tt.shape == (b, n) and tt.dtype == np.int64
    np.testing.assert_array_equal(tt, jt)


def test_teacher_forced_logits_match_jax(params, rng):
    """Each cached step's logits against the JAX full-sequence forward over
    prompt + generated tokens, and against the port's own full forward."""
    jp, tp = params
    ids = _ids(rng, 2, 9)
    n = 7
    _, tt, logits = _both(params, ids, np.ones((2, 9), np.int64), n)
    assert logits.shape == (2, n, CFG.vocab_size) and logits.dtype == torch.float32
    seq = np.concatenate([ids, tt[:, :-1]], axis=1)
    want = np.asarray(jq.forward_logits(jp, JCFG, jnp.asarray(seq)))[:, 8:]
    np.testing.assert_allclose(logits.numpy(), want, atol=LOGIT_ATOL, rtol=0)
    full = tq.lm_logits(tp, tq.forward_hidden(tp, CFG, tq.embed_tokens(tp, torch.from_numpy(seq))),
                        CFG)[:, 8:]
    np.testing.assert_allclose(logits.numpy(), full.numpy(), atol=LOGIT_ATOL, rtol=0)


def test_left_padded_prompt(params, rng):
    """Rows left-padded by different amounts generate what they generate
    unpadded, and what the JAX package generates for the same batch."""
    rows = [rng.integers(1, CFG.vocab_size, n).astype(np.int64) for n in (6, 8)]
    padded = np.zeros((2, 9), np.int64)
    mask = np.zeros((2, 9), np.int64)
    for i, r in enumerate(rows):
        padded[i, 9 - len(r):], mask[i, 9 - len(r):] = r, 1
    jt, tt, _ = _both(params, padded, mask, 5)
    np.testing.assert_array_equal(tt, jt)
    for i, r in enumerate(rows):
        dense, _ = _port(params, r[None], np.ones((1, len(r)), np.int64), 5)
        np.testing.assert_array_equal(tt[i], dense[0])


def test_eos_stops_and_pads(params, rng):
    ids = _ids(rng, 1, 5)
    all_eos = list(range(CFG.vocab_size))
    jt, tt, logits = _both(params, ids, np.ones((1, 5), np.int64), 6, eos=all_eos)
    np.testing.assert_array_equal(tt, jt)
    assert (tt[0, 1:] == all_eos[0]).all()
    assert logits.shape[1] == 1                    # stopped after the first token


def test_eos_mid_sequence_stops_one_row_and_pads_it(params, rng):
    """A row that emits an EOS keeps eos[0] after it while the other row
    decodes on; the loop stops once both are done."""
    ids = _ids(rng, 2, 6)
    free, _ = _port(params, ids, np.ones((2, 6), np.int64), 8)
    stop = int(free[0, 2])
    eos = [7 if stop != 7 else 8, stop]            # eos[0] is the pad, not the stop token
    jt, tt, logits = _both(params, ids, np.ones((2, 6), np.int64), 8, eos=eos)
    np.testing.assert_array_equal(tt, jt)
    first = int(np.argmax(free[0] == stop))
    assert (tt[0, first + 1:] == eos[0]).all()
    np.testing.assert_array_equal(tt[0, :first + 1], free[0, :first + 1])
    hits = [int(np.argmax(np.isin(free[r], eos))) if np.isin(free[r], eos).any() else 7
            for r in range(2)]
    assert logits.shape[1] == max(hits) + 1


def test_lora_threads_through_generation(params, lora, rng):
    jl, tl, scale = lora
    ids = _ids(rng, 1, 6)
    mask = np.ones((1, 6), np.int64)
    base, _ = _port(params, ids, mask, 6)
    zero, _ = _port(params, ids, mask, 6, tlora=tl, scale=0.0)
    np.testing.assert_array_equal(zero, base)
    jt, tt, logits = _both(params, ids, mask, 6, jlora_=jl, tlora=tl, scale=scale)
    np.testing.assert_array_equal(tt, jt)
    assert list(tt[0]) != list(base[0]), "the LoRA perturbation must change the output"
    jp, _ = params
    seq = np.concatenate([ids, tt[:, :-1]], axis=1)
    want = np.asarray(jq.forward_logits(jp, JCFG, jnp.asarray(seq), lora=jl,
                                        lora_scale=scale))[:, 5:]
    np.testing.assert_allclose(logits.numpy(), want, atol=LOGIT_ATOL, rtol=0)


def test_cached_decode_equals_no_cache_rollout(params, rng):
    _, tp = params
    ids = list(rng.integers(0, CFG.vocab_size, 6))
    cur, rollout = list(ids), []
    for _ in range(6):
        h = tq.forward_hidden(tp, CFG, tq.embed_tokens(tp, torch.tensor([cur])))
        nxt = int(tq.lm_logits(tp, h[:, -1:], CFG)[0, 0].argmax())
        rollout.append(nxt)
        cur.append(nxt)
    tokens = tgen.generate_tokens(tp, CFG, tq.embed_tokens(tp, torch.tensor([ids])),
                                  torch.ones((1, 6), dtype=torch.int32), 6, NO_EOS)
    assert tokens[0].tolist() == rollout


def test_decode_one_matches_jax(params, rng):
    """One decode step on a half-filled cache with a masked prompt slot:
    hidden and both caches against the JAX package's decode_one."""
    jp, tp = params
    L, kh, hd = CFG.num_hidden_layers, CFG.num_key_value_heads, CFG.head_dim
    b, smax, cur = 2, 12, 7
    ck = rng.standard_normal((L, b, smax, kh, hd)).astype(np.float32)
    cv = rng.standard_normal((L, b, smax, kh, hd)).astype(np.float32)
    base = np.ones((b, smax), np.int32)
    base[1, :2] = 0
    emb = rng.standard_normal((b, 1, CFG.hidden_size)).astype(np.float32)
    pos = np.full((b, 1), cur, np.int32)
    jh, jc = jgen.decode_one(jp, JCFG, jnp.asarray(emb), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                             jnp.asarray(cur), jnp.asarray(base), jnp.asarray(pos))
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    th, tc = tgen.decode_one(tp, CFG, torch.from_numpy(emb), cache, cur, torch.from_numpy(base),
                             torch.from_numpy(pos))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), atol=1e-5, rtol=1e-4)
        np.testing.assert_array_equal(np.delete(tc[name].numpy(), cur, axis=2),
                                      np.delete(ck if name == "k" else cv, cur, axis=2))


def test_temperature_sampling(params, rng):
    """jax.random's draws cannot be reproduced by torch, so sampling is held
    to its own contract: one generator seed gives one sequence, another seed
    another; a temperature that drives every non-top probability to zero
    draws the greedy tokens; every token drawn at T = 1 has non-zero
    probability under the step's logits."""
    _, tp = params
    ids = _ids(rng, 2, 6)
    emb = tq.embed_tokens(tp, torch.from_numpy(ids))
    mask = torch.ones((2, 6), dtype=torch.int32)

    def sample(seed, t=1.0):
        return tgen.generate_tokens(tp, CFG, emb, mask, 8, NO_EOS, temperature=t,
                                    generator=torch.Generator().manual_seed(seed),
                                    return_logits=True)

    a, logits = sample(5)
    b, _ = sample(5)
    c, _ = sample(6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    probs = torch.softmax(logits, dim=-1).gather(-1, a[..., None])[..., 0]
    assert (probs > 0).all()
    greedy = tgen.generate_tokens(tp, CFG, emb, mask, 8, NO_EOS)
    cold, _ = sample(5, t=1e-6)
    torch.testing.assert_close(cold, greedy, rtol=0, atol=0)
    default_a = tgen.generate_tokens(tp, CFG, emb, mask, 4, NO_EOS, temperature=1.0)
    default_b = tgen.generate_tokens(tp, CFG, emb, mask, 4, NO_EOS, temperature=1.0)
    torch.testing.assert_close(default_a, default_b, rtol=0, atol=0)   # seed 0 without one


def test_keywords_trim_matches_jax():
    for text in ("hello world<|im_end|>\nextra", "no keyword here", "  pad  ", "a###b<|im_end|>"):
        for kws in (["<|im_end|>"], ["###", "<|im_end|>"]):
            assert tgen.KeywordsStoppingCriteria(kws, None).trim(text) == \
                jgen.KeywordsStoppingCriteria(kws, None).trim(text)
    assert tgen.KeywordsStoppingCriteria(["<|im_end|>"], None).trim(
        "hello world<|im_end|>\nextra") == "hello world"
