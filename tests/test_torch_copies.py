"""The port keeps its own copies of the JAX package's JAX-free helpers
(configs and the HF config reader, tokenizer, prompt layouts, train
collation and loader, dataset helpers, presets, metric logging, pack
schedulers, the rank-row shard arithmetic, recall and fusion, the results
table, every conversation template, the chat's frame sampling, the
feature-pack reader's C++ source, bench.py's caption generator).
Each copy is pinned equal to its original here; the extraction slice's copies (the ViT's position tables and resize
matrices, the image processor, the frame sampling, chunking and the feature
store) are pinned in tests/test_torch_vit.py and tests/test_torch_extract.py."""

import dataclasses

import numpy as np
import pytest

from blim_tpu.core import config as jconfig
from blim_tpu.core import constants as jconst
from blim_tpu.core import mesh as jmesh
from blim_tpu.data import collate as jcollate
from blim_tpu.data import conversation as jconv
from blim_tpu.data import datasets as jdatasets
from blim_tpu.data import prompts as jprompts
from blim_tpu.data.tokenization import ByteFallbackTokenizer as JTokenizer
from blim_tpu.engine import rerank as jrerank
from blim_tpu.scoring import fusion as jfusion
from blim_tpu.scoring import recall as jrecall

from blim_tpu_torch.core import config as tconfig
from blim_tpu_torch.core import constants as tconst
from blim_tpu_torch.data import collate as tcollate
from blim_tpu_torch.data import conversation as tconv
from blim_tpu_torch.data import datasets as tdatasets
from blim_tpu_torch.data import prompts as tprompts
from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer as TTokenizer
from blim_tpu_torch.engine import rerank as trerank
from blim_tpu_torch.scoring import fusion as tfusion
from blim_tpu_torch.scoring import recall as trecall
from blim_tpu_torch.utils import distributed as tdist

CAPTIONS = ["a cat sits on a mat", "children play soccer in the park",
            "a chef cooks pasta", "x", "waves crash against the rocks again and again"]


@pytest.mark.parametrize("make", [
    lambda m: m.ModelConfig(),
    lambda m: m.tiny_model_config(),
    lambda m: m.tiny_model_config(vocab_size=152064, num_clips=4),
], ids=["7b", "tiny", "tiny-152k"])
def test_config_copies_match(make):
    j, t = make(jconfig), make(tconfig)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.video_tokens_vtg == j.video_tokens_vtg
    assert t.tokens_per_clip == j.tokens_per_clip
    assert t.llm.num_query_groups == j.llm.num_query_groups
    for prop in ("patches_per_side", "patches_per_frame", "depth"):
        assert getattr(t.vision, prop) == getattr(j.vision, prop), prop


@pytest.mark.parametrize("kw", [dict(), dict(image_size=224), dict(image_size=64, patch_size=8,
                                                                   num_hidden_layers=4,
                                                                   return_idx=-1)])
def test_vision_config_copy_matches(kw):
    j, t = jconfig.VisionConfig(**kw), tconfig.VisionConfig(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.patches_per_side, t.patches_per_frame, t.depth) == (
        j.patches_per_side, j.patches_per_frame, j.depth)


def test_constants_match():
    for name in ("IGNORE_INDEX", "IMAGE_TOKEN_INDEX", "DEFAULT_IMAGE_TOKEN", "IMAGE_TOKEN_ID",
                 "IM_START_TOKEN_ID", "QWEN2_PAD_TOKEN_ID", "DEFAULT_IMAGE_PATCH_TOKEN",
                 "DEFAULT_IM_START_TOKEN", "DEFAULT_IM_END_TOKEN"):
        assert getattr(tconst, name) == getattr(jconst, name), name


@pytest.mark.parametrize("text", [
    "plain ascii", "<|im_start|>user\nhi<|im_end|>\n", "café ☃ <|endoftext|>", "",
])
def test_tokenizer_copy_matches(text):
    j, t = JTokenizer(), TTokenizer()
    assert t(text).input_ids == j(text).input_ids
    ids = j(text).input_ids
    for skip in (False, True):
        assert t.decode(ids, skip_special_tokens=skip) == j.decode(ids, skip_special_tokens=skip)
    assert (t.pad_token_id, t.eos_token_id, t.bos_token_id) == (
        j.pad_token_id, j.eos_token_id, j.bos_token_id)


def test_conversation_copy_matches():
    for msgs in ([("u", "hello"), ("a", None)], [("u", "<image>\nq"), ("a", "answer")], []):
        j = jconv.conv_templates["qwen_2"].copy()
        t = tconv.conv_templates["qwen_2"].copy()
        for role, m in msgs:
            j.append_message(j.roles[0] if role == "u" else j.roles[1], m)
            t.append_message(t.roles[0] if role == "u" else t.roles[1], m)
        assert t.get_prompt() == j.get_prompt()


@pytest.mark.parametrize("dataset", sorted(jprompts.VTG_INSTRUCTIONS))
def test_vtg_layout_copy_matches(dataset):
    jt, tt = JTokenizer(), TTokenizer()
    j = jprompts.make_vtg_layout(jt, dataset, 256, max_caption_tokens=96)
    t = tprompts.make_vtg_layout(tt, dataset, 256, max_caption_tokens=96)
    for f in ("pre_ids", "post_ids", "terminator_ids", "num_video_tokens",
              "max_caption_tokens", "seq_len", "pad_id", "video_start", "caption_start",
              "label_window", "prefix_len", "suffix_width"):
        assert getattr(t, f) == getattr(j, f), f
    np.testing.assert_array_equal(t.prefix_token_ids(), j.prefix_token_ids())
    for a, b in zip(t.prior_prefix(), j.prior_prefix()):
        np.testing.assert_array_equal(a, b)
    for cap in CAPTIONS:
        te, je = t.encode_caption(cap, tt, dataset), j.encode_caption(cap, jt, dataset)
        assert te.keys() == je.keys()
        for key in je:
            np.testing.assert_array_equal(te[key], je[key], err_msg=key)
    prompt = tprompts.vtg_prompt_strings("a caption", dataset)
    assert prompt == jprompts.vtg_prompt_strings("a caption", dataset)
    assert (tprompts.tokenizer_image_token(prompt[1], tt)
            == jprompts.tokenizer_image_token(prompt[1], jt))


def test_empty_caption_raises_like_the_original():
    t = tprompts.make_vtg_layout(TTokenizer(), "MSRVTT", 16)
    with pytest.raises(ValueError):
        t.encode_caption("", TTokenizer(), "MSRVTT")


def test_caption_bank_copy_matches():
    jl = jprompts.make_vtg_layout(JTokenizer(), "MSRVTT", 64, max_caption_tokens=24)
    tl = tprompts.make_vtg_layout(TTokenizer(), "MSRVTT", 64, max_caption_tokens=24)
    j = jrerank.CaptionBank.build_vtg(CAPTIONS, JTokenizer(), "MSRVTT", jl)
    t = trerank.CaptionBank.build_vtg(CAPTIONS, TTokenizer(), "MSRVTT", tl)
    for f in ("input_ids", "attention_mask", "cpn_mask", "window_labels", "suffix_ids",
              "suffix_mask", "suffix_labels"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)


@pytest.mark.parametrize("width", [15, 99, 768, 800, 1000])
def test_default_pack_sizes_copy_matches(width):
    assert trerank.default_pack_sizes(width) == jrerank.default_pack_sizes(width)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_packs_copy_matches(seed):
    rng = np.random.default_rng(seed)
    n_caps, n_pairs = 40, 200
    seg_lens = rng.integers(3, 60, n_caps)
    key = rng.integers(0, 7, n_pairs)
    cap = rng.integers(0, n_caps, n_pairs)
    sizes = trerank.default_pack_sizes(63)
    assert trerank.build_packs(key, cap, seg_lens, sizes) == jrerank.build_packs(
        key, cap, seg_lens, sizes)
    small = (64, 128)
    assert trerank.build_packs(key, cap, seg_lens, small) == jrerank.build_packs(
        key, cap, seg_lens, small)


def test_batch_plan_copy_matches():
    for m in range(0, 41):
        for G in (1, 2, 3, 5, 8):
            for n_data in (1, 2):
                if G % n_data:
                    continue
                assert trerank.batch_plan(m, G, n_data) == jrerank.batch_plan(m, G, n_data)


@pytest.mark.parametrize("n,ws", [(1000, 8), (17, 8), (5, 8), (8, 8), (0, 8), (9, 2), (1, 1)])
def test_process_shard_bounds_copy_matches(n, ws):
    """tests/test_multihost_seams.py's cases: every rank's rows as JAX's."""
    for rank in range(ws):
        assert tdist.process_shard_bounds(n, ws, rank) == jmesh.process_shard_bounds(n, ws, rank)


@pytest.mark.parametrize("k", [1, 4, 9])
def test_topk_pairs_copy_matches(k):
    sims = np.random.default_rng(k).standard_normal((7, 9)).astype(np.float32)
    sims[2, 3] = sims[2, 5]  # an exact tie resolves by ascending index in both
    for a, b in zip(trerank.topk_pairs(sims, k), jrerank.topk_pairs(sims, k)):
        np.testing.assert_array_equal(a, b)


def test_unique_pairs_copy_matches():
    rng = np.random.default_rng(5)
    cap = rng.integers(0, 10, 80)
    vid = rng.integers(0, 6, 80)
    t, j = trerank.unique_pairs(cap, vid), jrerank.unique_pairs(cap, vid)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(np.reshape(a, -1), np.reshape(b, -1))
        assert a.dtype == b.dtype


def _score_mats(seed, n=12, zero=False):
    rng = np.random.default_rng(seed)
    t2v = rng.standard_normal((n, n)) + 0.01
    v2t = rng.standard_normal((n, n)) + 0.01
    if zero:
        v2t[3, 4] = 0.0  # the skipped-direction sentinel
    return t2v, v2t


@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("multi_gt", [False, True])
def test_get_recall_copy_matches(zero, multi_gt):
    t2v, v2t = _score_mats(3, zero=zero)
    n = t2v.shape[0]
    t2v_ids = {i: i for i in range(n)}
    v2t_ids = {i: ([i, (i + 1) % n] if multi_gt else i) for i in range(n)}
    assert trecall.get_recall(t2v, v2t, t2v_ids, v2t_ids) == jrecall.get_recall(
        t2v, v2t, t2v_ids, v2t_ids)


def _alt_inputs(kind):
    rng = np.random.default_rng(5)
    if kind == "random":
        return rng.standard_normal((40, 40))
    x = rng.integers(0, 4, size=(24, 24)).astype(np.float64)   # heavy ties
    x[3, :] = np.nan                                          # a NaN diagonal
    return x


def test_alt_metrics_source_is_a_copy_below_its_docstring():
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]

    def body(path):
        text = path.read_text()
        return text[text.index('"""', 3) + 3:]

    copy = repo / "blim_tpu_torch" / "scoring" / "alt_metrics.py"
    original = repo / "blim_tpu" / "scoring" / "alt_metrics.py"
    assert len(body(copy)) > 3000 and body(copy) == body(original)


@pytest.mark.parametrize("kind", ["random", "ties_nan"])
def test_compute_metrics_copies_match(kind):
    from blim_tpu.scoring import alt_metrics as jalt
    from blim_tpu_torch.scoring import alt_metrics as talt

    x = _alt_inputs(kind)
    t, j = trecall.compute_metrics(x), jrecall.compute_metrics(x)
    assert t == j and t == talt.compute_metrics(x) == jalt.compute_metrics(x)
    if kind == "ties_nan":
        assert len(t["cols"]) > 24          # the tie expansion happened


def test_alt_metrics_multi_sentence_and_tensor_copies_match(capsys):
    from blim_tpu.scoring import alt_metrics as jalt
    from blim_tpu_torch.scoring import alt_metrics as talt

    rng = np.random.default_rng(6)
    sim = rng.standard_normal((12, 5, 12))
    sim[4, 3:, :] = -np.inf
    sim[7, 4, :] = np.nan
    assert talt.tensor_text_to_video_metrics(sim) == jalt.tensor_text_to_video_metrics(sim)
    np.testing.assert_array_equal(talt.tensor_video_to_text_sim(sim),
                                  jalt.tensor_video_to_text_sim(sim))
    logits = rng.standard_normal((15, 6))
    assert talt.multi_sentence_retrieval(logits, [2, 5, 6, 10, 12, 14]) == \
        jalt.multi_sentence_retrieval(logits, [2, 5, 6, 10, 12, 14])
    m = talt.compute_metrics(rng.standard_normal((30, 30)))
    talt.print_metrics(30, 30, m, m, m, m)
    ours = capsys.readouterr().out
    jalt.print_metrics(30, 30, m, m, m, m)
    assert ours == capsys.readouterr().out and "R@1" in ours


@pytest.mark.parametrize("cpn,has_tvg", [(True, False), (False, False), (True, True)])
def test_all_scoring_results_copy_matches(cpn, has_tvg):
    n = 12
    rng = np.random.default_rng(9)
    mat = lambda: rng.standard_normal((n, n)) + 0.01  # noqa: E731
    t2v = {"internvideo2": mat(), "query_likelihood": mat()}
    v2t = {"internvideo2": mat(), "candidate_likelihood": mat(), "candidate_prior": mat()}
    if has_tvg:
        t2v.update(candidate_likelihood=mat(), candidate_prior=mat())
        v2t.update(query_likelihood=mat())
    ids = {i: i for i in range(n)}
    args = (ids, ids, (0.3, 0.8), (0.5, 0.4, 0.8, 0.6), cpn, has_tvg)
    assert tfusion.all_scoring_results(t2v, v2t, *args) == jfusion.all_scoring_results(
        t2v, v2t, *args)
    for a, b in zip(tfusion.blim_ensemble(t2v, v2t, (0.3, 0.8), (0.5, 0.4, 0.8, 0.6), has_tvg),
                    jfusion.blim_ensemble(t2v, v2t, (0.3, 0.8), (0.5, 0.4, 0.8, 0.6), has_tvg)):
        np.testing.assert_array_equal(a, b)


LONG = "word " * 200  # overflows the TVG budget: the caption is cut, the header tail kept


@pytest.mark.parametrize("num_clips,budget", [(4, 96), (4, 32), (8, 64)])
def test_tvg_layout_copy_matches(num_clips, budget):
    jt, tt = JTokenizer(), TTokenizer()
    j = jprompts.make_tvg_layout(jt, num_clips, max_caption_tokens=budget)
    t = tprompts.make_tvg_layout(tt, num_clips, max_caption_tokens=budget)
    for f in ("terminator_ids", "tvg_prefix_length", "num_clips", "seq_len", "pad_id",
              "video_start", "prefix_len", "suffix_width"):
        assert getattr(t, f) == getattr(j, f), f
    np.testing.assert_array_equal(t.gather_positions, j.gather_positions)
    for cap in CAPTIONS + [LONG]:
        te, je = t.encode_caption(cap, tt), j.encode_caption(cap, jt)
        assert te.keys() == je.keys()
        for key in je:
            np.testing.assert_array_equal(te[key], je[key], err_msg=key)


def test_tvg_prompt_helpers_copy_match():
    assert tprompts.TVG_INSTRUCTION == jprompts.TVG_INSTRUCTION
    for cap in CAPTIONS:
        assert tprompts.tvg_prompt_strings(cap) == jprompts.tvg_prompt_strings(cap)
    assert tprompts.get_tvg_prefix_length(TTokenizer()) == jprompts.get_tvg_prefix_length(
        JTokenizer())
    assert tprompts.get_tvg_prefix_length(TTokenizer(), "short") == \
        jprompts.get_tvg_prefix_length(JTokenizer(), "short")


def test_collate_train_batch_copy_matches():
    jt, tt = JTokenizer(), TTokenizer()
    feats = np.random.default_rng(0).standard_normal((5, 4, 8, 6)).astype(np.float32)
    labels = np.array([3, 1, 4, 1, 0])
    out = {}
    for name, mod, pm, tok in (("j", jcollate, jprompts, jt), ("t", tcollate, tprompts, tt)):
        vl = pm.make_vtg_layout(tok, "DiDeMo", 32, max_caption_tokens=24)
        tl = pm.make_tvg_layout(tok, 4, max_caption_tokens=24)
        out[name] = mod.collate_train_batch(CAPTIONS, feats, labels, tok, "DiDeMo", vl, tl)
    assert out["t"].keys() == out["j"].keys()
    for key in out["j"]:
        np.testing.assert_array_equal(out["t"][key], out["j"][key], err_msg=key)
        assert out["t"][key].dtype == out["j"][key].dtype, key


@pytest.mark.parametrize("n,batch,shards,drop_last", [
    (10, 4, 1, False), (10, 4, 1, True), (3, 4, 1, False), (11, 3, 2, False), (11, 3, 2, True),
])
def test_train_loader_copy_matches(n, batch, shards, drop_last):
    caps = [f"c{i}" for i in range(n)]
    vid = np.arange(n) % 3
    jds = jdatasets.RetrievalDataset("MSRVTT", "train", [str(v) for v in vid], caps, None,
                                     ["0", "1", "2"], vid)
    tds = tdatasets.RetrievalDataset("MSRVTT", caps, vid)
    assert len(tds) == len(jds)
    for shard in range(shards):
        j = jdatasets.TrainLoader(jds, batch, seed=5, num_shards=shards, shard=shard,
                                  drop_last=drop_last)
        t = tdatasets.TrainLoader(tds, batch, seed=5, num_shards=shards, shard=shard,
                                  drop_last=drop_last)
        assert len(t) == len(j)
        for epoch in (0, 1):
            jb, tb = list(j.batches(epoch)), list(t.batches(epoch))
            assert len(tb) == len(jb)
            for a, b in zip(tb, jb):
                np.testing.assert_array_equal(a, b)


def test_tvg_caption_bank_copy_matches():
    jl = jprompts.make_tvg_layout(JTokenizer(), 4, max_caption_tokens=24)
    tl = tprompts.make_tvg_layout(TTokenizer(), 4, max_caption_tokens=24)
    j = jrerank.CaptionBank.build_tvg(CAPTIONS + [LONG], JTokenizer(), jl)
    t = trerank.CaptionBank.build_tvg(CAPTIONS + [LONG], TTokenizer(), tl)
    for f in ("input_ids", "attention_mask", "cpn_mask", "prefix_ids", "prefix_mask",
              "prefix_cpn", "first_ids"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
        assert getattr(t, f).dtype == getattr(j, f).dtype, f


@pytest.mark.parametrize("prefix_len", [40, 249, 384, 512, 513, 900])
def test_default_tvg_classes_and_q_buckets_copy_match(prefix_len):
    t = trerank.default_tvg_pack_classes(prefix_len)
    assert t == jrerank.default_tvg_pack_classes(prefix_len)
    assert trerank.default_tvg_q_buckets(t) == jrerank.default_tvg_q_buckets(t)


@pytest.mark.parametrize("classes", [((64, 20),), ((128, 33), (256, 64)), ((96, 32), (512, 200))])
def test_default_tvg_q_buckets_copy_matches(classes):
    assert trerank.default_tvg_q_buckets(classes) == jrerank.default_tvg_q_buckets(classes)


def _tvg_pairs(seed, n_caps=30, n_vids=50):
    rng = np.random.default_rng(seed)
    seg_lens = rng.integers(20, 250, n_caps).astype(np.int32)
    k = rng.integers(1, 45 if seed < 2 else 400, n_caps)   # seed 2 splits captions past 160
    cap = np.repeat(np.arange(n_caps), k)
    vid = rng.integers(0, n_vids, len(cap))
    order = rng.permutation(len(cap))   # pairs arrive in no particular order
    return cap[order], vid[order], seg_lens


def _plain_tvg_packs(out):
    return [(size, qn, [[(c, v.tolist(), p.tolist()) for c, v, p in segs] for segs in packs])
            for size, qn, packs in out]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("decoupled", [False, True], ids=["coupled", "q_buckets"])
def test_build_tvg_packs_copy_matches(seed, decoupled):
    cap, vid, seg_lens = _tvg_pairs(seed)
    classes = trerank.default_tvg_pack_classes(249)
    qb = trerank.default_tvg_q_buckets(classes) if decoupled else None
    t = trerank.build_tvg_packs(cap, vid, seg_lens, classes, q_buckets=qb)
    j = jrerank.build_tvg_packs(cap, vid, seg_lens, classes, q_buckets=qb)
    assert _plain_tvg_packs(t) == _plain_tvg_packs(j)
    # the head-only prior packs: every segment the same length
    heads = np.full(len(seg_lens), 17, np.int32)
    assert _plain_tvg_packs(trerank.build_tvg_packs(cap, vid, heads, classes, q_buckets=qb)) == \
        _plain_tvg_packs(jrerank.build_tvg_packs(cap, vid, heads, classes, q_buckets=qb))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("head", [False, True], ids=["full", "head_len"])
def test_assemble_tvg_packs_bulk_matches_loop_and_jax(seed, head):
    """The port's bulk pack assembly against its own loop version and against
    the JAX package's bulk version, with and without the prior's head_len."""
    import types

    tt, jt = TTokenizer(), JTokenizer()
    tl = tprompts.make_tvg_layout(tt, 4, max_caption_tokens=48)
    jl = jprompts.make_tvg_layout(jt, 4, max_caption_tokens=48)
    rng = np.random.default_rng(seed)
    caps = [" ".join(rng.choice(["a", "dog", "runs", "in", "the", "park", "slowly"],
                                rng.integers(1, 12))) for _ in range(12)]
    bank = trerank.CaptionBank.build_tvg(caps, tt, tl)
    banks = {"prefix_ids_host": bank.prefix_ids,
             "prefix_len_host": bank.prefix_mask.sum(axis=1).astype(np.int32)}
    head_len = tl.tvg_prefix_length if head else None
    cap = rng.integers(0, len(caps), 90)
    vid = rng.integers(0, 20, 90)
    lens = banks["prefix_len_host"] if not head else np.full(len(caps), head_len, np.int32)
    classes = trerank.default_tvg_pack_classes(tl.prefix_len)
    tself = types.SimpleNamespace(tvg_layout=tl)
    jself = types.SimpleNamespace(tvg_layout=jl)
    n_classes = 0
    for size, qn, packs in trerank.build_tvg_packs(cap, vid, lens, classes,
                                                   trerank.default_tvg_q_buckets(classes)):
        n_classes += 1
        *bulk, pair_pos = trerank.RerankEngine._assemble_tvg_packs_bulk(
            tself, banks, packs, size, qn, head_len)
        *jbulk, jpair_pos = jrerank.RerankEngine._assemble_tvg_packs_bulk(
            jself, banks, packs, size, qn, head_len)
        for a, b in zip(bulk, jbulk):
            np.testing.assert_array_equal(a, b)
        for i, segs in enumerate(packs):
            *row, pp = trerank.RerankEngine._assemble_tvg_pack(tself, banks, segs, size, qn,
                                                               head_len)
            for a, b in zip(row, bulk):
                np.testing.assert_array_equal(a, b[i])
            np.testing.assert_array_equal(pp, pair_pos[i])
            np.testing.assert_array_equal(pp, jpair_pos[i])
    assert n_classes >= 1


# ---------------------------------------------------------------------------
# the CLI slice's copies: HF config reader, presets, dataset helpers, metric
# logging, the results table
# ---------------------------------------------------------------------------

HF_DICTS = [
    {},
    {"vocab_size": 152064, "hidden_size": 3584, "intermediate_size": 18944,
     "num_hidden_layers": 28, "num_attention_heads": 28, "num_key_value_heads": 4,
     "mm_vision_tower": "umt-hd-large", "mm_hidden_size": 1024, "mm_local_num_frames": 4},
    {"hidden_size": 64, "num_attention_heads": 4, "head_dim": 32, "mm_vision_tower": "umt-large",
     "mm_vision_select_layer": -5, "tie_word_embeddings": True, "use_sliding_window": 1,
     "sliding_window": None, "llm_compress_layer_list": None, "llm_image_token_ratio_list": [],
     "tokenizer_model_max_length": 8192, "tokenizer_padding_side": "right",
     "mm_llm_compress": 1, "mm_newline_position": "grid", "rope_theta": 5e5},
    {"num_hidden_layers": 4, "max_window_layers": 2, "llm_compress_layer_list": [1, 2],
     "llm_image_token_ratio_list": [1.0, 0.5], "mm_projector_type": "mlp2x_gelu"},
]


@pytest.mark.parametrize("d", HF_DICTS, ids=["empty", "7b", "odd", "compress"])
def test_from_hf_config_dict_copy_matches(d):
    t, j = tconfig.from_hf_config_dict(dict(d)), jconfig.from_hf_config_dict(dict(d))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_hf_7b_config_is_the_default_config():
    assert tconfig.from_hf_config_dict(HF_DICTS[1]) == tconfig.ModelConfig()


def test_presets_copy_match():
    from blim_tpu.pipelines import configs as jpresets
    from blim_tpu_torch.pipelines import configs as tpresets

    assert tpresets.TRAIN_PRESETS == jpresets.TRAIN_PRESETS
    assert tpresets.ZEROSHOT_PRESETS == jpresets.ZEROSHOT_PRESETS
    import argparse

    for ds in jpresets.TRAIN_PRESETS:
        for zeroshot in (False, True):
            t = tpresets.apply_preset(argparse.Namespace(dataset=ds, topk=1), zeroshot=zeroshot)
            j = jpresets.apply_preset(argparse.Namespace(dataset=ds, topk=1), zeroshot=zeroshot)
            assert vars(t) == vars(j)


def test_dataset_helper_copies_match():
    assert tdatasets.ANNOTATION_FILES == jdatasets.ANNOTATION_FILES
    assert tdatasets.DATASETS == jdatasets.DATASETS
    for name, video in (("MSRVTT", "video7.mp4"), ("DiDeMo", "a.b.mp4"),
                        ("ActivityNet", "v_x.mkv"), ("LSMDC", "1001_Movie/1001_clip.avi")):
        assert tdatasets._vid_from_path(name, video) == jdatasets._vid_from_path(name, video)
    for name, caption in (("MSRVTT", "  a cat  "), ("DiDeMo", ["a man", " runs "]),
                          ("ActivityNet", [" one.", " two. "]), ("LSMDC", 7)):
        assert tdatasets._caption(name, caption) == jdatasets._caption(name, caption)


def _feed(mod):
    meter = mod.SmoothedValue(window_size=3)
    for i, v in enumerate([0.5, 2.0, 1.25, 7.0, 3.5]):
        meter.update(v, n=i % 2 + 1)
    logger = mod.MetricLogger(delimiter=" | ")
    logger.add_meter("lr", mod.SmoothedValue(window_size=1, fmt="{value:.6f}"))
    for i in range(4):
        logger.update(loss=1.0 / (i + 1), lr=1e-4 * i)
    return meter, logger


def test_metric_logging_copies_match(capsys):
    from blim_tpu.utils import logging as jlogging
    from blim_tpu_torch.utils import logging as tlogging

    (tm, tl), (jm, jl) = _feed(tlogging), _feed(jlogging)
    for attr in ("median", "avg", "global_avg", "max", "value", "count", "total"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert str(tm) == str(jm) and str(tl) == str(jl)
    assert tl.loss.global_avg == jl.loss.global_avg
    tl.synchronize_between_processes()
    assert str(tl) == str(jl)

    def lines(mod, logger):
        import re

        list(logger.log_every(range(5), 2, header="Epoch: [0]"))
        # the clock readings differ; the rest of each line must not
        return [re.sub(r"(eta|time|data|Total time): \S+", r"\1: T", ln)
                for ln in capsys.readouterr().out.splitlines()]

    assert lines(tlogging, tl) == lines(jlogging, jl)


def test_results_table_fallback_copy_matches(monkeypatch):
    import sys

    from blim_tpu.engine import loop as jloop
    from blim_tpu_torch.engine import loop as tloop

    results = {"internvideo2": {"t2v_r1": 12.5, "t2v_r5": 40.0, "r_mean": 33.333},
               "blim": {"t2v_r1": 50.0, "t2v_r5": 87.5, "r_mean": 70.1}}
    monkeypatch.setitem(sys.modules, "pandas", None)        # the card machine has no pandas
    t, j = tloop.results_table(results), jloop.results_table(results)
    assert t == j and "blim" in t and "70.10" in t


# ---------------------------------------------------------------------------
# the chat slice's copies: every conversation template, the chat's frame
# sampling, the native feature-pack reader's source
# ---------------------------------------------------------------------------

TURNS = [("u", "<image>\nWhat happens?"), ("a", "A cat jumps."), ("u", "Then?"), ("a", None)]


@pytest.mark.parametrize("name", sorted(jconv.conv_templates))
def test_every_conversation_template_copy_matches(name):
    j, t = jconv.conv_templates[name], tconv.conv_templates[name]
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert td.pop("sep_style").name == jd.pop("sep_style").name
    assert td == jd
    for n in range(1, len(TURNS) + 1):
        jc, tc = j.copy(), t.copy()
        for role, m in TURNS[:n]:
            jc.append_message(jc.roles[0] if role == "u" else jc.roles[1], m)
            tc.append_message(tc.roles[0] if role == "u" else tc.roles[1], m)
        assert tc.get_prompt() == jc.get_prompt()
    assert (tconv.default_conversation.get_prompt()
            == jconv.default_conversation.get_prompt())
    assert [s.name for s in tconv.SeparatorStyle] == [s.name for s in jconv.SeparatorStyle]


@pytest.mark.parametrize("vlen,fps,cap,lf", [
    (300, 30.0, 512, 4), (30000, 30.0, 512, 4), (10, 30.0, 512, 4), (0, 25.0, 512, 4),
    (16, 2.0, 512, 2), (16, 2.0, 4, 2), (514, 1.0, 512, 4), (1000, 0.0, 64, 4), (97, 3.3, 512, 1),
])
def test_sample_frame_indices_copy_matches(vlen, fps, cap, lf):
    from blim_tpu.data.video import sample_frame_indices as jsample
    from blim_tpu_torch.data.video import sample_frame_indices as tsample

    t, j = tsample(vlen, fps, cap, lf), jsample(vlen, fps, cap, lf)
    np.testing.assert_array_equal(t, j)
    assert t.dtype == j.dtype and len(t) % lf == 0


def test_feature_pack_source_is_a_byte_copy():
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    copy = repo / "blim_tpu_torch" / "data" / "csrc" / "feature_pack.cpp"
    assert copy.read_bytes() == (repo / "native" / "feature_pack.cpp").read_bytes()


# ---------------------------------------------------------------------------
# the last public surface's copies: the fusion grid searches, the flat prompt
# example functions and splice, the FLOP accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["calculate_score", "calculate_cpn_score"])
def test_grid_search_source_is_a_byte_copy(name):
    import inspect

    assert inspect.getsource(getattr(tfusion, name)) == inspect.getsource(getattr(jfusion, name))


@pytest.mark.parametrize("name", ["build_vtg_example", "build_tvg_example", "splice_flat_example"])
def test_flat_example_source_is_a_byte_copy(name):
    import inspect

    assert inspect.getsource(getattr(tprompts, name)) == inspect.getsource(getattr(jprompts, name))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_searches_copy_match(seed):
    """Seeded matrices kept off an exact 0.0 score (get_recall reads one as
    a skipped direction): the same blends and the same chosen weights."""
    n = 16
    rng = np.random.default_rng(seed)
    mat = lambda: rng.standard_normal((n, n)) + 0.01  # noqa: E731
    ids = {i: i for i in range(n)}
    args = (mat(), mat(), mat(), mat(), ids, ids)
    assert all((a != 0.0).all() for a in args[:4])
    for name in ("calculate_score", "calculate_cpn_score"):
        got = getattr(tfusion, name)(*args)
        want = getattr(jfusion, name)(*args)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:] == want[2:], name
        assert all(c in [round(x, 1) for x in np.linspace(0, 1, 11)] for c in got[2:])


def test_flops_module_is_a_copy_but_for_the_peak_lookup():
    from pathlib import Path

    from blim_tpu.utils import flops as jflops
    from blim_tpu_torch.utils import flops as tflops

    repo = Path(__file__).resolve().parents[1]

    def body(path):
        text = path.read_text()
        return text[text.index("def decoder_matmul_flops_per_token("):
                    text.index("def peak_flops_per_chip(")]

    copy = body(repo / "blim_tpu_torch" / "utils" / "flops.py")
    assert len(copy) > 6000 and copy == body(repo / "blim_tpu" / "utils" / "flops.py")
    assert tflops.PEAK_BF16_FLOPS == jflops.PEAK_BF16_FLOPS
    cfg, jcfg = tconfig.ModelConfig(), jconfig.ModelConfig()
    lens = np.array([5, 17, 33, 1])
    for fn, a in (("full_forward_flops", (4, 448, 34)), ("prefix_forward_flops", (8, 341)),
                  ("suffix_forward_flops", (16, 24, 341, 23)),
                  ("packed_suffix_forward_flops", (3, 128, 341)),
                  ("packed_prefix_kv_flops", (2, 512)), ("flat_query_suffix_flops", (9, 4, 512)),
                  ("suffix_forward_flops_varlen", (lens, 341)),
                  ("prefix_forward_flops_varlen", (lens,))):
        assert getattr(tflops, fn)(cfg.llm, *a) == getattr(jflops, fn)(jcfg.llm, *a), fn
    assert tflops.tvg_head_flops(cfg, 28.0, 64) == jflops.tvg_head_flops(jcfg, 28.0, 64)
    kw = dict(batch=4, vtg_seq=448, vtg_lm_positions=34, tvg_seq=256, vocab_videos=64, lora_r=8,
              vtg_video_tokens=256, tvg_video_tokens=4)
    assert (tflops.train_step_executed_flops(cfg, **kw)
            == jflops.train_step_executed_flops(jcfg, **kw))


def test_peak_flops_reads_a_torch_device(monkeypatch):
    import torch

    from blim_tpu_torch.utils import flops as tflops

    assert tflops.peak_flops_per_chip("cpu") is None
    assert tflops.peak_flops_per_chip(torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, want in (("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", None),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, _n=name: _n)
        assert tflops.peak_flops_per_chip("cuda") == want, name
        assert tflops.peak_flops_per_chip(torch.device("cuda", 0)) == want, name


@pytest.mark.parametrize("copy", ["scripts/analyze_schedule_torch.py", "chip_smoke.py"])
@pytest.mark.parametrize("seed,n,budget", [(0, 64, 96), (3, 200, 20), (7, 50, 8)])
def test_caption_generator_copies_match_bench(copy, seed, n, budget):
    """The port's schedule analyser and chip_smoke.py keep their own copy of
    bench.py's synthetic caption generator: the same words and, from the same
    rng, the same captions."""
    import importlib.util
    from pathlib import Path

    import bench

    path = Path(__file__).resolve().parents[1] / copy
    spec = importlib.util.spec_from_file_location(f"_copy_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.WORDS == bench.WORDS
    got = module.make_captions(n, np.random.default_rng(seed), budget)
    assert len(got) == n and got == bench.make_captions(n, np.random.default_rng(seed), budget)
