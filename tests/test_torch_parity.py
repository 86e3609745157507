"""The port's last public functions against the JAX package's, and the
port's accuracy-parity harness (scripts/parity_torch.py), on the CPU.

  * qwen2.forward_logits with and without a LoRA tree, with a key mask and
    with position ids: within 1e-4 x max|logits| of JAX's (fp32, 2 layers);
  * criteria.vtg_likelihood on chunked_window_logits against JAX's, and
    against the port's fused vtg_likelihood_from_hidden;
  * lora.lora_delta at p = 0 against JAX's, and its dropout by its
    semantics (jax.random's draws cannot be matched bit for bit);
    merge_lora_into_dense against JAX's exactly in fp32 and bf16;
    apply_dense with a LoRA against the merged dense without; merge_lora's
    tree scoring with lora=None as the LoRA-applied tree scores;
  * the flat prompt examples and splice_flat_example against JAX's, array
    for array, and the port's layouts held to the splice (as
    tests/test_prompts_layout.py holds the JAX layouts);
  * batch_decode, video_tokens_tvg, RerankEngine.close;
  * each step of scripts/parity_torch.py at a small vocabulary (a byte
    tokenizer whose special ids sit under 512): step 1 against a stand-in
    reference built on the JAX package's flat examples, step 2 against
    transformers' Qwen2, step 3 against cached features made by the JAX
    featurizer, step 4's recall against the JAX evaluation of the same
    checkpoint and data, step 5's trajectory; PASS, FAIL and SKIP paths;
  (the whole `--synthetic --device cpu` run is tests/test_torch_parity_script.py).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blim_tpu.adapters import lora as jlora
from blim_tpu.core import config as jconfig
from blim_tpu.data import prompts as jprompts
from blim_tpu.data.tokenization import ByteFallbackTokenizer as JTokenizer
from blim_tpu.models import qwen2 as jq
from blim_tpu.models import videochat_flash as jvcf
from blim_tpu.scoring import criteria as jcrit

from blim_tpu_torch.adapters import lora as tlora
from blim_tpu_torch.checkpoints.convert import params_from_numpy
from blim_tpu_torch.core import config as tconfig
from blim_tpu_torch.core.constants import IGNORE_INDEX
from blim_tpu_torch.data import prompts as tprompts
from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
from blim_tpu_torch.engine.rerank import CaptionBank, RerankEngine
from blim_tpu_torch.models import qwen2 as tq
from blim_tpu_torch.models import videochat_flash as tvcf
from blim_tpu_torch.scoring import criteria as tcrit
from test_torch_tvg import _lora_numpy

torch.backends.cuda.matmul.allow_tf32 = False

REPO = Path(__file__).resolve().parents[1]
SCALE = tlora.LoraConfig().scale
CAPTIONS = ["a cat sits", "x", "many people dance in the rain", "café ☃ again"]


def _load_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location("parity_torch",
                                                  REPO / "scripts" / "parity_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PT = _load_script()


@pytest.fixture(scope="module")
def model():
    """The tiny config at vocab 512, its JAX params and the port's bridged
    copy, and a LoRA tree with non-zero B factors (JAX and port)."""
    jcfg = jconfig.tiny_model_config(vocab_size=512, num_clips=4)
    tcfg = tconfig.tiny_model_config(vocab_size=512, num_clips=4)
    jp = jvcf.init_params(jcfg, jax.random.key(3))
    npp = jax.tree_util.tree_map(np.asarray, jp)
    lora_np = _lora_numpy(jcfg, 4)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=params_from_numpy(npp, torch.float32, "cpu"),
                jl=jax.tree_util.tree_map(jnp.asarray, lora_np),
                tl=params_from_numpy(lora_np, device="cpu"))


# ---------------------------------------------------------------------------
# forward_logits, the window CE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_lora", [False, True], ids=["base", "lora"])
@pytest.mark.parametrize("inputs", ["ids", "mask_positions"])
def test_forward_logits_matches_jax(model, with_lora, inputs):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 512, size=(2, 19))
    mask = pos = None
    if inputs == "mask_positions":
        mask = np.ones((2, 19), np.int32)
        mask[1, 13:] = 0                                  # a right-padded row
        pos = np.broadcast_to(np.arange(19) + 7, (2, 19)).astype(np.int32).copy()
        pos[0, 5:] += 40                                  # a gap, as the CPN prior prefix has
    jl = model["jl"]["llm"] if with_lora else None
    tl = model["tl"]["llm"] if with_lora else None
    want = np.asarray(jq.forward_logits(
        model["jp"]["llm"], model["jcfg"].llm, jnp.asarray(ids),
        None if mask is None else jnp.asarray(mask), None if pos is None else jnp.asarray(pos),
        lora=jl, lora_scale=SCALE, use_pallas=False))
    got = tq.forward_logits(model["tp"]["llm"], model["tcfg"].llm, torch.from_numpy(ids),
                            None if mask is None else torch.from_numpy(mask),
                            None if pos is None else torch.from_numpy(pos),
                            lora=tl, lora_scale=SCALE)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 19, 512)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    if with_lora:       # the adapters act
        base = tq.forward_logits(model["tp"]["llm"], model["tcfg"].llm, torch.from_numpy(ids),
                                 None if mask is None else torch.from_numpy(mask),
                                 None if pos is None else torch.from_numpy(pos))
        assert np.abs(base.numpy() - want).max() > 1e-3 * np.abs(want).max()


def test_window_ce_routes_match_jax_and_each_other():
    rng = np.random.default_rng(2)
    h = rng.standard_normal((3, 9, 64)).astype(np.float32)
    k = rng.standard_normal((64, 700)).astype(np.float32) * 0.1
    labels = rng.integers(0, 700, size=(3, 9))
    labels[0, 6:] = IGNORE_INDEX
    labels[2, :] = IGNORE_INDEX                  # a row with no label scores 0
    logits = tcrit.chunked_window_logits(torch.from_numpy(h), torch.from_numpy(k))
    jlogits = jcrit.chunked_window_logits(jnp.asarray(h), jnp.asarray(k))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-5)
    got = tcrit.vtg_likelihood(logits, torch.from_numpy(labels))
    want = np.asarray(jcrit.vtg_likelihood(jlogits, jnp.asarray(labels)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    fused = tcrit.vtg_likelihood_from_hidden(torch.from_numpy(h), torch.from_numpy(k),
                                             torch.from_numpy(labels))
    np.testing.assert_allclose(fused.numpy(), got.numpy(), atol=1e-5, rtol=1e-5)
    assert got[2].item() == 0.0 and (got[:2] < 0).all()


# ---------------------------------------------------------------------------
# LoRA: the delta, the merge
# ---------------------------------------------------------------------------

def _factors(rng, lead, din, dout, r=8):
    a = rng.standard_normal(lead + (din, r)).astype(np.float32) * 0.2
    b = rng.standard_normal(lead + (r, dout)).astype(np.float32) * 0.2
    return a, b


def test_lora_delta_matches_jax_without_dropout():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    a, b = _factors(rng, (), 24, 40)
    want = jlora.lora_delta({"a": jnp.asarray(a), "b": jnp.asarray(b)}, jnp.asarray(x), SCALE)
    for gen in (None, torch.Generator().manual_seed(0)):
        got = tlora.lora_delta({"a": torch.from_numpy(a), "b": torch.from_numpy(b)},
                               torch.from_numpy(x), SCALE, 0.0, gen)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_lora_delta_dropout_semantics():
    """With identity factors the delta is dropout(x) itself: zeros where an
    element was dropped, x / (1 - p) where it was kept, about 1 - p kept,
    a fresh draw each call, the same draw from the same seed."""
    p, n = 0.3, 4096
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((4, n // 64, 64))
                         .astype(np.float32)) + 3.0          # no element is 0
    eye = {"a": torch.eye(64), "b": torch.eye(64)}
    gen = torch.Generator().manual_seed(11)
    d1 = tlora.lora_delta(eye, x, 1.0, p, gen)
    d2 = tlora.lora_delta(eye, x, 1.0, p, gen)
    kept = d1 != 0
    torch.testing.assert_close(d1[kept], x[kept] / (1 - p), rtol=1e-6, atol=0)
    assert abs(kept.float().mean().item() - (1 - p)) < 0.03
    assert not torch.equal(kept, d2 != 0)
    again = tlora.lora_delta(eye, x, 1.0, p, torch.Generator().manual_seed(11))
    assert torch.equal(again, d1)
    # apply_dense draws the same mask for its LoRA branch
    dense = {"kernel": torch.zeros(64, 64)}
    y = tlora.apply_dense(dense, x, eye, 2.0, p, torch.Generator().manual_seed(11))
    assert torch.equal(y, 2.0 * d1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lora_into_dense_matches_jax(dtype):
    rng = np.random.default_rng(5)
    kernel = rng.standard_normal((3, 32, 48)).astype(np.float32)       # stacked (L, in, out)
    bias = rng.standard_normal((3, 48)).astype(np.float32)
    a, b = _factors(rng, (3,), 32, 48)
    jd = jlora.merge_lora_into_dense(
        {"kernel": jnp.asarray(kernel, getattr(jnp, dtype)), "bias": jnp.asarray(bias)},
        {"a": jnp.asarray(a), "b": jnp.asarray(b)}, SCALE)
    td = tlora.merge_lora_into_dense(
        {"kernel": torch.from_numpy(kernel).to(getattr(torch, dtype)),
         "bias": torch.from_numpy(bias)},
        {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}, SCALE)
    assert td["kernel"].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(td["kernel"].float().numpy(),
                                  np.asarray(jd["kernel"].astype(jnp.float32)))
    assert td["bias"] is not None and torch.equal(td["bias"], torch.from_numpy(bias))


def test_apply_dense_with_lora_equals_the_merged_dense():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 7, 32)).astype(np.float32))
    dense = {"kernel": torch.from_numpy(rng.standard_normal((32, 48)).astype(np.float32)),
             "bias": torch.from_numpy(rng.standard_normal(48).astype(np.float32))}
    a, b = _factors(rng, (), 32, 48)
    lora = {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}
    applied = tlora.apply_dense(dense, x, lora, SCALE)
    merged = tlora.apply_dense(tlora.merge_lora_into_dense(dense, lora, SCALE), x)
    torch.testing.assert_close(merged, applied, atol=1e-4, rtol=1e-5)
    assert (applied - tlora.apply_dense(dense, x)).abs().max() > 0.1


def test_merged_tree_scores_as_the_applied_lora(model, tokenizer):
    """merge_lora folds the LLM's q/k/v/o and lm_head factors and the
    projector's: VTG and TVG scores and forward_logits of the merged tree
    without a LoRA equal the applied LoRA's; a tied lm_head is untied."""
    cfg, tp, tl = model["tcfg"], model["tp"], model["tl"]
    merged = tlora.merge_lora(tp, tl, SCALE)
    assert merged["llm"]["embed_tokens"] is tp["llm"]["embed_tokens"]
    rng = np.random.default_rng(7)
    video = torch.from_numpy(rng.standard_normal(
        (len(CAPTIONS), cfg.num_clips, cfg.tokens_per_clip, cfg.mm_hidden_size))
        .astype(np.float32) * 0.5)
    small = _SmallVocabTokenizer()
    vtg = tprompts.make_vtg_layout(small, "MSRVTT", cfg.video_tokens_vtg, 32)
    bank = CaptionBank.build_vtg(CAPTIONS, small, "MSRVTT", vtg)
    batch = {k: torch.from_numpy(getattr(bank, k)) for k in
             ("input_ids", "attention_mask", "cpn_mask", "window_labels")}
    batch["video"] = video
    ws, wl = vtg.label_window
    for cpn in (False, True):
        want = tvcf.score_vtg(tp, cfg, batch, vtg.video_start, ws, wl, cpn=cpn, lora=tl,
                              lora_scale=SCALE)
        got = tvcf.score_vtg(merged, cfg, batch, vtg.video_start, ws, wl, cpn=cpn)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        base = tvcf.score_vtg(tp, cfg, batch, vtg.video_start, ws, wl, cpn=cpn)
        assert (base - want).abs().max() > 1e-3
    tvg = tprompts.make_tvg_layout(small, cfg.num_clips, 32)
    tbank = CaptionBank.build_tvg(CAPTIONS, small, tvg)
    tbatch = {k: torch.from_numpy(getattr(tbank, k)) for k in
              ("input_ids", "attention_mask", "cpn_mask")}
    tbatch.update(video=video, video_label=torch.arange(len(CAPTIONS)))
    vocab = video.mean(dim=2)
    gs = int(tvg.gather_positions[0])
    for cpn in (False, True):
        want = tvcf.score_tvg(tp, cfg, tbatch, vocab, tvg.video_start, gs, cpn=cpn, lora=tl,
                              lora_scale=SCALE)
        got = tvcf.score_tvg(merged, cfg, tbatch, vocab, tvg.video_start, gs, cpn=cpn)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    tied = dict(tp["llm"], lm_head={"kernel": None})
    ids = torch.from_numpy(rng.integers(0, 512, size=(2, 11)))
    want = tq.forward_logits(tied, cfg.llm, ids, lora=tl["llm"], lora_scale=SCALE)
    m = tlora.merge_lora({"llm": tied}, {"llm": tl["llm"]}, SCALE)["llm"]
    assert m["lm_head"]["kernel"] is not None and tied["lm_head"]["kernel"] is None
    torch.testing.assert_close(tq.forward_logits(m, cfg.llm, ids), want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the flat prompt examples, the splice, the small copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("caption", CAPTIONS)
def test_flat_examples_and_splice_match_jax(caption):
    jt, tt = JTokenizer(), ByteFallbackTokenizer()
    for dataset in sorted(tprompts.VTG_INSTRUCTIONS):
        pairs = [(tprompts.build_vtg_example(caption, dataset, tt),
                  jprompts.build_vtg_example(caption, dataset, jt), False)]
        if dataset == "MSRVTT":
            pairs.append((tprompts.build_tvg_example(caption, tt),
                          jprompts.build_tvg_example(caption, jt), True))
        for got, want, tvg in pairs:
            assert got.keys() == want.keys()
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
                assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
            tpl = jprompts.get_tvg_prefix_length(jt) if tvg else 0
            n = 4 if tvg else 256
            gs = tprompts.splice_flat_example(got, n, tvg=tvg, tvg_prefix_length=tpl)
            ws = jprompts.splice_flat_example(want, n, tvg=tvg, tvg_prefix_length=tpl)
            assert gs.keys() == ws.keys()
            for key in ws:
                np.testing.assert_array_equal(gs[key], ws[key], err_msg=key)


def test_port_vtg_layout_matches_the_splice():
    tok = ByteFallbackTokenizer()
    layout = tprompts.make_vtg_layout(tok, "MSRVTT", num_video_tokens=256, max_caption_tokens=32)
    for caption in CAPTIONS:
        ref = tprompts.splice_flat_example(tprompts.build_vtg_example(caption, "MSRVTT", tok),
                                           256, tvg=False, tvg_prefix_length=0)
        enc = layout.encode_caption(caption, tok, "MSRVTT")
        n = int(enc["real_len"])
        assert n == len(ref["input_ids"])
        nonvid = ref["is_video"][:n] == 0
        assert (enc["input_ids"][:n][nonvid] == ref["input_ids"][nonvid]).all()
        for key in ("is_video", "labels", "cpn_mask"):
            assert (enc[key][:n] == ref[key]).all(), key
        assert (enc["attention_mask"][n:] == 0).all()
        assert (enc["labels"][n:] == IGNORE_INDEX).all()


def test_port_tvg_layout_matches_the_splice():
    tok = ByteFallbackTokenizer()
    tpl = tprompts.get_tvg_prefix_length(tok)
    layout = tprompts.make_tvg_layout(tok, num_clips=4, max_caption_tokens=32)
    for caption in CAPTIONS:
        ref = tprompts.splice_flat_example(tprompts.build_tvg_example(caption, tok), 4,
                                           tvg=True, tvg_prefix_length=tpl)
        enc = layout.encode_caption(caption, tok)
        n = int(enc["real_len"])
        assert n == len(ref["input_ids"])
        off = layout.seq_len - n
        nonvid = ref["is_video"] == 0
        assert (enc["input_ids"][off:][nonvid] == ref["input_ids"][nonvid]).all()
        assert (enc["is_video"][off:] == ref["is_video"]).all()
        assert (enc["cpn_mask"][off:] == ref["cpn_mask"]).all()
        assert (enc["attention_mask"][:off] == 0).all() and (enc["attention_mask"][off:] == 1).all()
        labeled = np.nonzero(enc["labels"] != IGNORE_INDEX)[0]
        assert list(labeled) == [layout.seq_len - 2, layout.seq_len - 1]


def test_batch_decode_and_video_tokens_tvg_match_jax():
    jt, tt = JTokenizer(), ByteFallbackTokenizer()
    batch = [jt(c).input_ids for c in CAPTIONS] + [jt("<|im_start|>hi<|im_end|>").input_ids]
    for skip in (False, True):
        assert tt.batch_decode(batch, skip_special_tokens=skip) == jt.batch_decode(
            batch, skip_special_tokens=skip)
    for kw in ({}, {"num_clips": 7}):
        assert (tconfig.tiny_model_config(**kw).video_tokens_tvg
                == jconfig.tiny_model_config(**kw).video_tokens_tvg)
    assert tconfig.ModelConfig().video_tokens_tvg == jconfig.ModelConfig().video_tokens_tvg == 4


def test_close_drops_the_engine_state(model):
    tok = _SmallVocabTokenizer()
    cfg = model["tcfg"]
    engine = RerankEngine(model["tp"], cfg, tprompts.make_vtg_layout(
        tok, "MSRVTT", cfg.video_tokens_vtg, 32), lora=model["tl"], lora_scale=SCALE,
        device="cpu")
    engine.compute_prior_kv(engine.vtg_layout)
    engine.flops, engine.useful_flops = 3.0, 2.0
    assert engine._prior_kv_cache is not None
    engine.close()
    for name in ("params", "lora", "_prior_kv_cache"):
        assert not hasattr(engine, name)
    engine.close()                          # idempotent
    with pytest.raises(AttributeError, match="_prior_kv_cache"):
        engine.compute_prior_kv(engine.vtg_layout)
    engine.reset_flops()
    assert engine.flops == engine.useful_flops == 0.0


# ---------------------------------------------------------------------------
# scripts/parity_torch.py, step by step at a small vocabulary
# ---------------------------------------------------------------------------

class _SmallVocabTokenizer(ByteFallbackTokenizer):
    """The byte tokenizer with its special ids moved under 512."""

    SPECIALS = {"<|im_start|>": 300, "<|im_end|>": 301, "<|endoftext|>": 302}
    eos_token_id = 301
    pad_token_id = 302


def _args(tmp_path, *extra):
    return PT.get_args_parser().parse_args(
        ["--device", "cpu", "--reference", str(tmp_path / "no_reference"), *extra])


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """parity_torch's synthetic checkpoint, dataset and scores at vocab 512,
    and the checkpoint loaded by the port."""
    from blim_tpu_torch.checkpoints.convert import load_videochat_flash

    tmp = tmp_path_factory.mktemp("parity")
    cfg = tconfig.tiny_model_config(vocab_size=512)
    args = _args(tmp)
    PT.make_synthetic(args, str(tmp), cfg)
    params = load_videochat_flash(args.model_path, cfg, dtype=torch.float32, device="cpu")
    return dict(args=args, cfg=cfg, params=params, tmp=tmp)


def _run(step, *a):
    PT.RESULTS.clear()
    step(*a)
    (result,) = PT.RESULTS
    return result


_REFERENCE = '''
import numpy as np
import torch

from blim_tpu.data.prompts import build_tvg_example, build_vtg_example, get_tvg_prefix_length


class BaseDataset:
    """A stand-in for the reference's dataset: its get_vtg_id and
    get_tvg_id return the JAX package's flat examples as torch tensors."""

    def get_tvg_prefix_length(self, init_prompt):
        return get_tvg_prefix_length(self.tokenizer, init_prompt)

    def _ids(self, ex):
        labels = ex["labels"].astype(np.int64)
        labels[-1] += OFFSET
        return (torch.from_numpy(ex["input_ids"].astype(np.int64)), torch.from_numpy(labels),
                torch.from_numpy(ex["attention_mask"].astype(np.int64)))

    def get_vtg_id(self, item):
        return self._ids(build_vtg_example(item["text"], self.args.dataset, self.tokenizer))

    def get_tvg_id(self, item):
        return self._ids(build_tvg_example(item["text"], self.tokenizer))
'''


@pytest.mark.parametrize("offset,status", [(None, "SKIP"), (0, "PASS"), (1, "FAIL")])
def test_step1_tokenizer_goldens(tmp_path, monkeypatch, offset, status):
    args = _args(tmp_path)
    if offset is not None:
        pkg = tmp_path / "no_reference" / "dataloader"
        pkg.mkdir(parents=True)
        (pkg / "__init__.py").write_text("")
        (pkg / "base_dataset.py").write_text(f"OFFSET = {offset}\n" + _REFERENCE)
        for mod in ("dataloader", "dataloader.base_dataset"):
            monkeypatch.delitem(sys.modules, mod, raising=False)
    step, got, detail = _run(PT.step_tokenizer_goldens, args, ByteFallbackTokenizer(), CAPTIONS)
    assert (step, got) == ("1 tokenizer goldens", status), detail
    assert str(args.reference) not in sys.path
    if status == "FAIL":
        assert f"{2 * len(CAPTIONS)} mismatches" in detail


def test_step2_logit_parity_against_transformers(synthetic, monkeypatch):
    from blim_tpu_torch.checkpoints.convert import load_hf_state_dict

    monkeypatch.setenv("USE_TF", "0")       # transformers' import skips TensorFlow
    s = synthetic
    args = _args(s["tmp"], "--logit_layers", "0")
    step, status, detail = _run(PT.step_logit_parity, args,
                                load_hf_state_dict(s["args"].model_path), s["cfg"],
                                torch.device("cpu"))
    assert (step, status) == ("2 logit parity", "PASS"), detail
    assert "2 layers on cpu" in detail


def test_step2_skips_without_transformers(synthetic, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)      # import raises ImportError
    step, status, detail = _run(PT.step_logit_parity, synthetic["args"], {}, synthetic["cfg"],
                                torch.device("cpu"))
    assert (step, status) == ("2 logit parity", "SKIP") and "transformers" in detail


def test_step3_feature_parity_against_the_jax_featurizer(tmp_path):
    """The port's featurizer through the step against .pth features the JAX
    featurizer made from the same frames: PASS; negated: FAIL; no videos or
    no tower: SKIP."""
    import cv2

    from blim_tpu.models import umt_vit as jvit
    from blim_tpu.pipelines import extract as jex
    from blim_tpu_torch.models import umt_vit as tvit
    from blim_tpu_torch.pipelines import extract as tex

    vision = dict(image_size=64, hidden_size=128, num_attention_heads=2, num_hidden_layers=3,
                  return_idx=-2, num_frames=2)
    model = dict(mm_hidden_size=128, mm_local_num_frames=2, num_clips=2, tokens_per_frame=2)
    jcfg = jconfig.ModelConfig(vision=jconfig.VisionConfig(**vision), **model)
    tcfg = tconfig.ModelConfig(vision=tconfig.VisionConfig(**vision), **model)
    rng = np.random.default_rng(8)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        jvit.init_params(jcfg.vision, jax.random.key(0)))
    videos, feats = tmp_path / "videos", tmp_path / "data" / "MSRVTT" / "features"
    feats.mkdir(parents=True)
    for v in range(2):
        frames_dir = videos / f"v{v}"
        frames_dir.mkdir(parents=True)
        for i in range(6):
            cv2.imwrite(str(frames_dir / f"frame_{i:04d}.jpg"),
                        rng.integers(0, 256, (48, 56, 3), dtype=np.uint8))
        lf = tcfg.mm_local_num_frames
        pixels = tvit.UMTImageProcessor((64, 64)).preprocess(
            tex.read_frames(str(frames_dir), num_frames=tcfg.num_clips * lf))
        pixels = pixels.reshape(1, -1, lf, *pixels.shape[1:])
        ref = np.array(jex.make_featurizer(jp, jcfg)(jnp.asarray(pixels)))[0]
        torch.save(torch.from_numpy(ref).to(torch.float16), str(feats / f"v{v}.pth"))
    params = {"vision_tower": params_from_numpy(jp, torch.float32, "cpu")}
    args = _args(tmp_path, "--videos_dir", str(videos), "--data_root", str(tmp_path / "data"))
    step, status, detail = _run(PT.step_feature_parity, args, params, tcfg, torch.device("cpu"))
    assert (step, status) == ("3 feature parity", "PASS") and "2 videos" in detail, detail
    for v in range(2):
        path = str(feats / f"v{v}.pth")
        torch.save(-torch.load(path), path)
    assert _run(PT.step_feature_parity, args, params, tcfg, torch.device("cpu"))[1] == "FAIL"
    assert _run(PT.step_feature_parity, _args(tmp_path), params, tcfg,
                torch.device("cpu"))[1] == "SKIP"
    assert _run(PT.step_feature_parity, args, {}, tcfg, torch.device("cpu"))[1] == "SKIP"


def _recall_line(blim):
    return ", ".join(f"{k}={blim[k]:.1f}" for k in ("t2v_r1", "t2v_r5", "v2t_r1", "v2t_r5"))


def test_step4_score_parity_matches_the_jax_evaluation(synthetic):
    """The step's recall against the JAX package's val_one_epoch on the same
    checkpoint, data and preset; --expected within / outside the tolerance."""
    from blim_tpu.checkpoints.convert import convert_videochat_flash, load_hf_state_dict
    from blim_tpu.core.mesh import make_mesh
    from blim_tpu.data.datasets import load_dataset, load_iv2_scores
    from blim_tpu.engine import loop as jloop
    from blim_tpu.engine.rerank import RerankEngine as JaxRerankEngine
    from blim_tpu.pipelines.configs import ZEROSHOT_PRESETS

    s, tok = synthetic, _SmallVocabTokenizer()
    args = s["args"]
    step, status, detail = _run(PT.step_score_parity, args, s["params"], s["cfg"], tok, None,
                                torch.device("cpu"))
    assert (step, status) == ("4 score parity (zero-shot)", "SKIP") and "computed (" in detail

    jcfg = jconfig.tiny_model_config(vocab_size=512)
    jp = convert_videochat_flash(load_hf_state_dict(args.model_path), jcfg)
    preset = ZEROSHOT_PRESETS["MSRVTT"]
    fs = (jcfg.num_clips, jcfg.tokens_per_clip, jcfg.mm_hidden_size)
    engine = JaxRerankEngine(jp, jcfg, jprompts.make_vtg_layout(tok, "MSRVTT",
                                                               jcfg.video_tokens_vtg, 96),
                             None, make_mesh(devices=jax.devices()[:1]))
    results = jloop.val_one_epoch(
        engine, load_dataset("MSRVTT", args.data_root, "test", fs),
        load_iv2_scores(args.scores_dir, "MSRVTT", zeroshot=True), tok, preset["topk"],
        preset["cpn"], tuple(preset["alpha"]), tuple(preset["c"]), has_tvg=False)
    line = _recall_line(results["blim"])
    assert f"computed ({line})" in detail

    for shift, want in ((0.1, "PASS"), (1.0, "FAIL")):
        expected = {"blim": {k: v + shift for k, v in results["blim"].items()
                             if k in ("t2v_r1", "v2t_r1", "t2v_r5")}}
        assert _run(PT.step_score_parity, args, s["params"], s["cfg"], tok, expected,
                    torch.device("cpu"))[1] == want


def test_step5_train_trajectory(synthetic):
    s, tok = synthetic, _SmallVocabTokenizer()
    step, status, detail = _run(PT.step_train_trajectory, s["args"], s["params"], s["cfg"], tok,
                                None, torch.device("cpu"))
    assert (step, status) == ("5 train trajectory", "PASS"), detail
    assert detail.startswith("3 steps, loss ")
    first = float(detail.split("loss ")[1].split(" ->")[0])
    assert np.isfinite(first) and first > 0
    near = {"train_losses": [first + 0.001] * 3}
    off = {"train_losses": [first + 1.0] * 3}
    assert _run(PT.step_train_trajectory, s["args"], s["params"], s["cfg"], tok, near,
                torch.device("cpu"))[1] == "PASS"
    assert _run(PT.step_train_trajectory, s["args"], s["params"], s["cfg"], tok, off,
                torch.device("cpu"))[1] == "FAIL"


def test_main_without_a_checkpoint_skips_every_step(tmp_path, capsys):
    rc = PT.main(["--device", "cpu", "--model_path", str(tmp_path / "none"),
                  "--reference", str(tmp_path / "none"), "--captions", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    for step in ("1 tokenizer goldens", "2 logit parity", "3 feature parity",
                 "4 score parity (zero-shot)", "5 train trajectory"):
        assert f"SKIP  {step}" in out
    assert 'launches: {"flash_fwd": 0' in out


def test_synthetic_config_has_the_kernels_head_dim_on_the_card():
    cuda = PT.synthetic_config(torch.device("cuda"))
    cpu = PT.synthetic_config(torch.device("cpu"))
    assert cuda.llm.head_dim == 128 and cuda.llm.vocab_size == cpu.llm.vocab_size == 152064
    assert cuda.llm.num_attention_heads % cuda.llm.num_key_value_heads == 0
    assert cpu.llm.head_dim == 16
