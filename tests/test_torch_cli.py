"""The port's train/eval CLI and what it reads, against the JAX package, on
the CPU at the tiny config (fp32).

  * config: `load_model_config` on one config.json gives the same fields in
    both packages;
  * data: `load_dataset` and `load_iv2_scores` (.npz and .pth) give the
    same items, vids, vocabulary, features and matrices;
  * eval parity: the port's `val_one_epoch` against the JAX package's on the
    same weights, zero-shot and fine-tuned (a LoRA tree bridged from the JAX
    init with its B factors made non-zero): every score matrix within atol
    1e-4 / rtol 1e-4 (fp32 through two layers and a 152k-way CE), the recall
    tables equal;
  * the CLI in-process with --device cpu: a --tiny eval writes log.txt with
    a blim row; one --tiny training epoch writes epoch0/ and
    checkpoint_best/; --eval --resume reproduces that epoch's table; and
    --model_path on a tiny checkpoint directory of the parity weights gives
    the parity case's table;
  * extraction: `extract.main` on a checkpoint directory with a (one-block,
    full-width) tower saves the features the featurizer computes on the
    same converted tower;
  * the tokenizer loader, with `transformers` present, loads a WordLevel
    tokenizer.json to the same ids and pad id as the JAX package's.
"""

import argparse
import builtins
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blim_tpu.core import config as jconfig
from blim_tpu.core.mesh import make_mesh
from blim_tpu.data import datasets as jdatasets
from blim_tpu.data import tokenization as jtokenization
from blim_tpu.data.prompts import make_tvg_layout as jax_make_tvg_layout
from blim_tpu.data.prompts import make_vtg_layout as jax_make_vtg_layout
from blim_tpu.engine import loop as jloop
from blim_tpu.engine.rerank import RerankEngine as JaxRerankEngine
from blim_tpu.models import videochat_flash as jvcf

from blim_tpu_torch.adapters.lora import LoraConfig
from blim_tpu_torch.checkpoints import convert, safetensors_io
from blim_tpu_torch.core import config as tconfig
from blim_tpu_torch.data import datasets as tdatasets
from blim_tpu_torch.data import tokenization as ttokenization
from blim_tpu_torch.data.prompts import make_tvg_layout, make_vtg_layout
from blim_tpu_torch.engine import loop as tloop
from blim_tpu_torch.engine.rerank import RerankEngine
from blim_tpu_torch.kernels import flash_attention as tfa
from blim_tpu_torch.models import umt_vit
from blim_tpu_torch.pipelines import extract as tex
from blim_tpu_torch.pipelines import main as tmain
from test_torch_tvg import _lora_numpy

torch.backends.cuda.matmul.allow_tf32 = False

N_TEST, TOPK, CAPS = 8, 4, 48
SHAPE = (4, 64, 32)                 # (clips, tokens, mm) at the tiny config
ALPHA, C = (0.0, 0.8), (1.0, 0.5, 0.8, 0.6)
SCALE = LoraConfig().scale
WORDS = ["man", "dog", "runs", "park", "sings", "car", "cooks", "kitchen", "a", "the"]

# the tiny config as a VideoChat-Flash config.json
TINY_HF = {"vocab_size": 152064, "hidden_size": 64, "intermediate_size": 128,
           "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
           "max_position_embeddings": 2048, "rope_theta": 1e6, "rms_norm_eps": 1e-6,
           "max_window_layers": 28, "tie_word_embeddings": False, "mm_hidden_size": 32,
           "mm_local_num_frames": 4,
           "mm_vision_tower": "umt-hd-large", "mm_projector_type": "tome16_mlp_hd64"}


def _scores(rng, n):
    """InternVideo2 stand-ins: the true video ahead (so R@1 > 0), kept off
    the exact 0.0 that recall reads as a skipped direction."""
    m = rng.standard_normal((n, n)).astype(np.float32) + 0.01
    return m + 2.0 * np.eye(n, dtype=np.float32)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """MSRVTT-shaped root: 8 test items over 8 videos, 8 train items of
    which one has no features (train drops it), fp16 features, and the
    zero-shot and fine-tuned score matrices as .npz (and as .pth in
    scores_pth/)."""
    root = tmp_path_factory.mktemp("data")
    ds = root / "MSRVTT"
    (ds / "features").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(N_TEST):
        np.save(ds / "features" / f"video{i}.npy",
                (rng.standard_normal(SHAPE) * 0.5).astype(np.float16))

    def caption():
        return " " + " ".join(rng.choice(WORDS, size=rng.integers(3, 9))) + " "

    test = [{"video": f"video{i}.mp4", "caption": caption()} for i in range(N_TEST)]
    train = [{"video": f"video{i % 7}.mp4", "caption": caption()} for i in range(7)]
    train.append({"video": "video99.mp4", "caption": caption()})
    for split, annos in (("test", test), ("train", train)):
        (ds / tdatasets.ANNOTATION_FILES["MSRVTT"][split]).write_text(json.dumps(annos))
    for d in ("scores", "scores_pth"):
        (root / d).mkdir()
    for stem in ("msrvtt", "msrvtt_zeroshot"):
        t2v, v2t = _scores(rng, N_TEST), _scores(rng, N_TEST)
        np.savez(root / "scores" / f"{stem}.npz", t2v=t2v, v2t=v2t)
        torch.save({"t2v": torch.from_numpy(t2v).half(), "v2t": torch.from_numpy(v2t)},
                   root / "scores_pth" / f"{stem}.pth")
    return root


# ---------------------------------------------------------------------------
# config and data
# ---------------------------------------------------------------------------

def test_load_model_config_matches_jax(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(
        dict(TINY_HF, mm_vision_select_layer=-3, llm_compress_layer_list=[4, 8],
             tokenizer_model_max_length=4096)))
    t, j = tconfig.load_model_config(str(tmp_path)), jconfig.load_model_config(str(tmp_path))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.llm == tconfig.tiny_model_config(vocab_size=152064).llm
    assert t.vision.image_size == 448 and t.vision.depth == 22


@pytest.mark.parametrize("split", ["test", "train"])
def test_load_dataset_matches_jax(data_root, split):
    t = tdatasets.load_dataset("MSRVTT", str(data_root), split, SHAPE)
    j = jdatasets.load_dataset("MSRVTT", str(data_root), split, SHAPE)
    assert len(t) == len(j) == (N_TEST if split == "test" else 7)
    assert (t.name, t.split, t.vids, t.captions, t.vocab_vids) == (
        j.name, j.split, j.vids, j.captions, j.vocab_vids)
    np.testing.assert_array_equal(t.item_video_idx, j.item_video_idx)
    assert t.item_video_idx.dtype == j.item_video_idx.dtype
    np.testing.assert_array_equal(t.video_labels, j.video_labels)
    np.testing.assert_array_equal(t.load_features(), j.load_features())
    np.testing.assert_array_equal(t.video_vocab(), j.video_vocab())


@pytest.mark.parametrize("scores", ["scores", "scores_pth"])
@pytest.mark.parametrize("zeroshot", [True, False])
def test_load_iv2_scores_matches_jax(data_root, scores, zeroshot):
    t = tdatasets.load_iv2_scores(str(data_root / scores), "MSRVTT", zeroshot)
    j = jdatasets.load_iv2_scores(str(data_root / scores), "MSRVTT", zeroshot)
    assert t.keys() == j.keys() == {"t2v", "v2t"}
    for k in j:
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])


def test_unknown_dataset_and_missing_scores_raise(data_root):
    with pytest.raises(ValueError, match="unknown dataset"):
        tdatasets.load_dataset("Kinetics", str(data_root), "test")
    with pytest.raises(FileNotFoundError):
        tdatasets.load_iv2_scores(str(data_root), "MSRVTT", True)


# ---------------------------------------------------------------------------
# val_one_epoch against the JAX package
# ---------------------------------------------------------------------------

def _spy(monkeypatch, module, store):
    real = module.evaluation

    def spy(*args, **kw):
        out = real(*args, **kw)
        store.append(out)
        return out

    monkeypatch.setattr(module, "evaluation", spy)


@pytest.fixture(scope="module")
def parity(data_root, tokenizer):
    jcfg = jconfig.tiny_model_config(vocab_size=152064, num_clips=4)
    tcfg = tconfig.tiny_model_config(vocab_size=152064, num_clips=4)
    jp = jvcf.init_params(jcfg, jax.random.key(0))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), torch.float32, "cpu")
    lora_np = _lora_numpy(jcfg, 5)
    jvtg = jax_make_vtg_layout(tokenizer, "MSRVTT", jcfg.video_tokens_vtg, CAPS)
    jtvg = jax_make_tvg_layout(tokenizer, jcfg.num_clips, CAPS)
    ttok = ttokenization.ByteFallbackTokenizer()
    tvtg = make_vtg_layout(ttok, "MSRVTT", tcfg.video_tokens_vtg, CAPS)
    ttvg = make_tvg_layout(ttok, tcfg.num_clips, CAPS)
    jds = jdatasets.load_dataset("MSRVTT", str(data_root), "test", SHAPE)
    tds = tdatasets.load_dataset("MSRVTT", str(data_root), "test", SHAPE)
    mesh = make_mesh(devices=jax.devices()[:1])
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, has_tvg in (("zeroshot", False), ("finetuned", True)):
            iv2 = tdatasets.load_iv2_scores(str(data_root / "scores"), "MSRVTT", not has_tvg)
            jmats, tmats = [], []
            _spy(mp, jloop, jmats)
            _spy(mp, tloop, tmats)
            jengine = JaxRerankEngine(
                jp, jcfg, jvtg, jtvg, mesh, lora=jax.tree_util.tree_map(jnp.asarray, lora_np)
                if has_tvg else None, lora_scale=SCALE)
            jres = jloop.val_one_epoch(jengine, jds, iv2, tokenizer, TOPK, True, ALPHA, C, has_tvg)
            tengine = RerankEngine(tp, tcfg, tvtg, ttvg, lora=convert.params_from_numpy(
                lora_np, device="cpu") if has_tvg else None, lora_scale=SCALE, device="cpu")
            tfa.reset_counts()
            tres = tloop.val_one_epoch(tengine, tds, iv2, ttok, TOPK, True, ALPHA, C, has_tvg)
            out[name] = dict(jax=jres, torch=tres, jmats=jmats[0], tmats=tmats[0],
                             counts=tfa.counts())
    finally:
        mp.undo()
    out["params"] = tp
    return out


MATRICES = {
    "zeroshot": [("v2t", "candidate_likelihood"), ("v2t", "candidate_prior"),
                 ("t2v", "query_likelihood"), ("v2t", "internvideo2"), ("t2v", "internvideo2")],
    "finetuned": [("v2t", "candidate_likelihood"), ("v2t", "candidate_prior"),
                  ("v2t", "query_likelihood"), ("t2v", "query_likelihood"),
                  ("t2v", "candidate_likelihood"), ("t2v", "candidate_prior"),
                  ("v2t", "internvideo2"), ("t2v", "internvideo2")],
}
CELLS = [(flow, d, n) for flow, mats in MATRICES.items() for d, n in mats]


@pytest.mark.parametrize("flow,direction,name", CELLS, ids=[f"{f}-{d}-{n}" for f, d, n in CELLS])
def test_val_one_epoch_matrices_match_jax(parity, flow, direction, name):
    (jt2v, jv2t), (tt2v, tv2t) = parity[flow]["jmats"], parity[flow]["tmats"]
    j = {"t2v": jt2v, "v2t": jv2t}[direction]
    t = {"t2v": tt2v, "v2t": tv2t}[direction]
    assert set(t) == set(j)
    assert t[name].shape == j[name].shape == (N_TEST, N_TEST)
    np.testing.assert_array_equal(t[name] == -100.0, j[name] == -100.0)
    np.testing.assert_allclose(t[name], j[name], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("flow", ["zeroshot", "finetuned"])
def test_val_one_epoch_recall_tables_match_jax(parity, flow):
    t, j = parity[flow]["torch"], parity[flow]["jax"]
    assert t == j
    assert "blim" in t and "cpn_candidate_likelihood" in t
    assert tloop.results_table(t) == jloop.results_table(j)
    assert sum(parity[flow]["counts"].values()) == 0


# ---------------------------------------------------------------------------
# the CLI in-process
# ---------------------------------------------------------------------------

def _main(argv):
    """Run the port's main with --device cpu, restoring the print that
    init_distributed_mode replaces."""
    args = argparse.ArgumentParser(parents=[tmain.get_args_parser()]).parse_args(
        argv + ["--device", "cpu"])
    print_ = builtins.print
    try:
        return args, tmain.main(args)
    finally:
        builtins.print = print_


def _common(data_root, out):
    return ["--dataset", "MSRVTT", "--data_root", str(data_root),
            "--scores_dir", str(data_root / "scores"), "--output_dir", str(out),
            "--topk", str(TOPK), "--cpn", "--max_caption_tokens", str(CAPS),
            "--alpha", *map(str, ALPHA), "--c", *map(str, C)]


@pytest.fixture(scope="module")
def tiny_runs(data_root, tmp_path_factory):
    """--tiny: zero-shot eval, one training epoch, then eval of the best
    checkpoint with --resume."""
    out = tmp_path_factory.mktemp("runs")
    _, zeroshot = _main(["--tiny", "--eval", *_common(data_root, out / "eval"),
                         "--model_path", str(out / "none")])
    train_args, train = _main(["--tiny", "--epochs", "1", "--batch_size", "4", "--lr", "1e-3",
                               *_common(data_root, out / "train"),
                               "--model_path", str(out / "none")])
    _, resumed = _main(["--tiny", "--eval", "--resume", str(out / "train" / "checkpoint_best"),
                        *_common(data_root, out / "resumed"), "--model_path", str(out / "none")])
    return dict(out=out, zeroshot=zeroshot, train=train, resumed=resumed, train_args=train_args)


def test_cli_eval_writes_log_with_a_blim_row(tiny_runs):
    log = (tiny_runs["out"] / "eval" / "log.txt").read_text()
    assert tloop.results_table(tiny_runs["zeroshot"]) in log
    assert any(line.startswith("blim ") for line in log.splitlines())
    assert "query_likelihood" in tiny_runs["zeroshot"]


def test_cli_train_epoch_saves_epoch_and_best(tiny_runs):
    from blim_tpu_torch.checkpoints import state_io

    out = tiny_runs["out"] / "train"
    for name in ("epoch0", "checkpoint_best"):
        d = out / name
        assert {p.name for p in d.iterdir()} == {"trainable.safetensors", "optimizer.pt",
                                                 "meta.json"}
        meta = json.loads((d / "meta.json").read_text())
        assert meta["epoch"] == 0 and meta["args"]["epochs"] == 1
        trainable, opt, epoch = state_io.load_checkpoint(str(d))
        assert meta["n_trainable"] == state_io.count_params(trainable) > 0
        assert opt["state"] and epoch == 0
    assert tiny_runs["train"]["blim"]["t2v_r1"] + tiny_runs["train"]["blim"]["v2t_r1"] > 0
    lines = (out / "log.txt").read_text().splitlines()
    stats = json.loads(lines[0])
    assert stats["epoch"] == 0 and np.isfinite(stats["train_loss"]) and "train_lr" in stats


def test_cli_resume_reproduces_the_epochs_table(tiny_runs):
    assert tiny_runs["resumed"] == tiny_runs["train"]
    assert tloop.results_table(tiny_runs["resumed"]) == tloop.results_table(tiny_runs["train"])
    assert tiny_runs["resumed"] != tiny_runs["zeroshot"]


@pytest.fixture(scope="module")
def tiny_checkpoint(parity, tmp_path_factory):
    """The parity weights as an HF checkpoint directory: config.json and
    fp32 shards written by the port's writer."""
    path = tmp_path_factory.mktemp("ckpt")
    (path / "config.json").write_text(json.dumps(TINY_HF))
    safetensors_io.save_sharded(convert.export_hf_state_dict(parity["params"]), str(path),
                                max_shard_bytes=20_000_000)
    return path


def test_cli_model_path_gives_the_parity_table(parity, tiny_checkpoint, data_root, tmp_path):
    _, res = _main(["--eval", "--model_path", str(tiny_checkpoint),
                    *_common(data_root, tmp_path / "out")])
    assert res == parity["zeroshot"]["torch"] == parity["zeroshot"]["jax"]
    assert tloop.results_table(res) in (tmp_path / "out" / "log.txt").read_text()


def test_cli_defaults_to_the_card(data_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    args = tmain.get_args_parser().parse_args(["--tiny", "--eval", "--output_dir", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tmain.main(args)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        convert.load_videochat_flash(str(tmp_path), tconfig.tiny_model_config())


# ---------------------------------------------------------------------------
# extraction from a checkpoint
# ---------------------------------------------------------------------------

def _tower_state_dict(vcfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    vd, vi, ps = vcfg.hidden_size, int(vcfg.hidden_size * vcfg.mlp_ratio), vcfg.patch_size

    def t(*shape, std=0.02):
        return torch.randn(shape, generator=g) * std

    vt = "model.vision_tower.vision_tower.encoder."
    sd = {vt + "patch_embed.proj.weight": t(vd, 3, vcfg.tubelet_size, ps, ps),
          vt + "patch_embed.proj.bias": t(vd), vt + "vision_layernorm.weight": 1 + t(vd),
          vt + "vision_layernorm.bias": t(vd)}
    for i in range(vcfg.depth):
        b = f"{vt}blocks.{i}."
        for n in ("norm1", "norm2"):
            sd[b + n + ".weight"] = 1 + t(vd)
            sd[b + n + ".bias"] = t(vd)
        sd.update({b + "attn.qkv.weight": t(3 * vd, vd), b + "attn.q_bias": t(vd),
                   b + "attn.v_bias": t(vd), b + "attn.proj.weight": t(vd, vd),
                   b + "attn.proj.bias": t(vd), b + "mlp.fc1.weight": t(vi, vd),
                   b + "mlp.fc1.bias": t(vi), b + "mlp.fc2.weight": t(vd, vi),
                   b + "mlp.fc2.bias": t(vd)})
    return sd


def test_extract_main_from_a_checkpoint_matches_the_featurizer(tmp_path):
    cv2 = pytest.importorskip("cv2")
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    # the published widths (ViT-L, 16 heads of 64) at res224, cut to one block
    (ckpt / "config.json").write_text(json.dumps(dict(
        TINY_HF, mm_vision_tower="umt-large", mm_vision_select_layer=-24)))
    cfg = tconfig.load_model_config(str(ckpt))
    assert (cfg.vision.image_size, cfg.vision.hidden_size, cfg.vision.depth) == (224, 1024, 1)
    safetensors_io.save_file(_tower_state_dict(cfg.vision), str(ckpt / "model.safetensors"))
    video = tmp_path / "data" / "MSRVTT" / "videos" / "clip7"
    os.makedirs(video)
    rng = np.random.default_rng(3)
    for i in range(6):
        cv2.imwrite(str(video / f"frame_{i:04d}.jpg"),
                    rng.integers(0, 256, (40, 56, 3), dtype=np.uint8))
    args = tex.get_args_parser().parse_args([
        "--dataset", "MSRVTT", "--data_root", str(tmp_path / "data"), "--model_path", str(ckpt),
        "--num_frames", "4", "--batch_size", "1", "--device", "cpu"])
    tex.main(args)
    saved = np.load(tmp_path / "data" / "MSRVTT" / "features" / "clip7.npy")

    tower = convert.params_from_numpy(convert.convert_vision_tower(
        convert.load_hf_state_dict(str(ckpt)), cfg.vision), torch.float32, "cpu")
    featurize = tex.make_featurizer(tower, cfg, device="cpu", device_preprocess=True)
    proc = umt_vit.UMTImageProcessor(size=(cfg.vision.image_size,) * 2)
    frames = tex.resize_for_upload(tex.read_frames(str(video), 4), proc, proc.size)
    want = featurize(torch.from_numpy(frames)[None, None]).to(torch.float16).numpy()[0]
    assert saved.shape == (1, cfg.tokens_per_clip, 1024) and saved.dtype == np.float16
    np.testing.assert_array_equal(saved, want)


# ---------------------------------------------------------------------------
# the tokenizer loader
# ---------------------------------------------------------------------------

@pytest.fixture()
def word_tokenizer_dir(tmp_path, monkeypatch):
    tokenizers = pytest.importorskip("tokenizers")
    pytest.importorskip("transformers")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    vocab = {w: i for i, w in enumerate(["[UNK]"] + WORDS)}
    vocab["<|endoftext|>"] = 151643          # Qwen2's pad token, which the loader sets
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    path = tmp_path / "qwen_words"
    path.mkdir()
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "[UNK]"}))
    return path


def test_load_tokenizer_matches_jax(word_tokenizer_dir):
    t = ttokenization.load_tokenizer(str(word_tokenizer_dir))
    j = jtokenization.load_tokenizer(str(word_tokenizer_dir))
    text = "a man runs the dog park zebra"
    assert t(text).input_ids == j(text).input_ids == [9, 1, 3, 10, 2, 4, 0]
    assert t.pad_token_id == j.pad_token_id == 151643


def test_load_tokenizer_falls_back_only_without_tokenizer_files(word_tokenizer_dir, tmp_path,
                                                                monkeypatch):
    assert isinstance(ttokenization.load_tokenizer(str(tmp_path / "empty")),
                      ttokenization.ByteFallbackTokenizer)
    assert isinstance(ttokenization.load_tokenizer(None), ttokenization.ByteFallbackTokenizer)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        ttokenization.load_tokenizer(str(word_tokenizer_dir))
