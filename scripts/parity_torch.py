#!/usr/bin/env python
"""Accuracy-parity harness of the PyTorch port: PARITY.md's five steps run
through blim_tpu_torch alone (torch, never jax), on the card by default.

Runs every step that its artifacts allow and prints PASS / FAIL / SKIP per
step; the exit code is 1 iff a step FAILs. Ground truth is the PyTorch
reference (its dataloader/base_dataset.py tokenization, its eval output).

With real artifacts, on a GPU:

    python scripts/parity_torch.py \
        --model_path ./pretrained/VideoChat-Flash-Qwen2-7B_res448 \
        --data_root ./data --scores_dir ./scores --dataset MSRVTT \
        [--reference ./reference] [--videos_dir ./videos] \
        [--expected expected.json] [--train_steps 8] [--device cuda]

  expected.json (from a reference run's log.txt) looks like
  {"blim": {"t2v_r1": 57.2, "t2v_r5": ..., "v2t_r1": ..., "v2t_r5": ...},
   "train_losses": [...]}.

Self-test without artifacts (a tiny model, synthetic data in a temporary
directory):

    python scripts/parity_torch.py --synthetic --device cpu
    python scripts/parity_torch.py --synthetic              # on the card

On the card the synthetic model has head dim 128 (hidden 256, 2 heads, one
K/V head), so steps 2, 4 and 5 run the hand-written kernels; on the CPU it
is the tests' tiny config. The last lines print the kernels' launch counts.

Steps:
  1 tokenizer goldens - build_vtg_example / build_tvg_example against the
    reference's get_vtg_id / get_tvg_id, imported from --reference; SKIP
    when it is not there.
  2 logit parity      - the checkpoint's Qwen2 through forward_logits
    against transformers' Qwen2ForCausalLM (eager attention) on text-only
    inputs, --logit_layers deep; SKIP when transformers is not installed.
  3 feature parity    - the port's featurizer against cached reference .pth
    features (token cos-sim > 0.999) on --videos_dir videos; SKIP without.
  4 score parity      - the zero-shot rerank with the preset fusion weights;
    R@1 / R@5 within --recall_tol of --expected (without it the numbers are
    printed and the comparison SKIPs).
  5 train trajectory  - preset fine-tune steps; losses finite and trending
    down; per-step losses against --expected's "train_losses" when given.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import tempfile
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = []
CAPTION_BUDGET = {"MSRVTT": 96, "LSMDC": 96, "DiDeMo": 160, "ActivityNet": 256}


def report(step: str, status: str, detail: str = ""):
    RESULTS.append((step, status, detail))
    print(f"[{status:4s}] {step}" + (f" - {detail}" if detail else ""), flush=True)


# ---------------------------------------------------------------------------
# step 1: tokenizer goldens
# ---------------------------------------------------------------------------

def step_tokenizer_goldens(args, tokenizer, captions):
    name = "1 tokenizer goldens"
    if not os.path.isdir(args.reference):
        report(name, "SKIP", f"no reference checkout at {args.reference}")
        return
    try:
        sys.path.insert(0, args.reference)
        from dataloader.base_dataset import BaseDataset  # noqa: the reference's code
    except Exception as e:
        report(name, "SKIP", f"reference not importable from {args.reference}: {e}")
        return
    finally:
        if args.reference in sys.path:
            sys.path.remove(args.reference)
    try:
        from blim_tpu_torch.data.prompts import (TVG_INSTRUCTION, build_tvg_example,
                                                 build_vtg_example, get_tvg_prefix_length)

        ref = BaseDataset.__new__(BaseDataset)
        ref.args = types.SimpleNamespace(dataset=args.dataset)
        ref.tokenizer = tokenizer
        ref.tvg_prefix_length = ref.get_tvg_prefix_length(TVG_INSTRUCTION)
        mismatches = []
        if ref.tvg_prefix_length != get_tvg_prefix_length(tokenizer):
            mismatches.append("tvg_prefix_length")
        for cap in captions:
            item = {"text": cap}
            for kind, got in (("vtg", build_vtg_example(cap, args.dataset, tokenizer)),
                              ("tvg", build_tvg_example(cap, tokenizer))):
                want = (ref.get_vtg_id if kind == "vtg" else ref.get_tvg_id)(item)
                if not all(np.array_equal(got[k], np.asarray(w))
                           for k, w in zip(("input_ids", "labels", "attention_mask"), want)):
                    mismatches.append(f"{kind}:{cap[:40]!r}")
        if mismatches:
            report(name, "FAIL", f"{len(mismatches)} mismatches, first: {mismatches[0]}")
        else:
            report(name, "PASS", f"{len(captions)} captions, vtg+tvg ids/labels/masks exact")
    except Exception as e:
        report(name, "FAIL", f"crashed: {e!r}")


# ---------------------------------------------------------------------------
# step 2: logit parity against transformers' Qwen2
# ---------------------------------------------------------------------------

def step_logit_parity(args, state_dict, config, device):
    name = "2 logit parity"
    try:
        from transformers import Qwen2Config as HFConfig
        from transformers.models.qwen2 import Qwen2ForCausalLM
    except ImportError as e:
        report(name, "SKIP", f"transformers is not installed ({e})")
        return
    try:
        import torch

        from blim_tpu_torch.checkpoints.convert import convert_qwen2, params_from_numpy
        from blim_tpu_torch.models import qwen2

        L = min(args.logit_layers or config.llm.num_hidden_layers,
                config.llm.num_hidden_layers)
        llm_cfg = dataclasses.replace(config.llm, num_hidden_layers=L)
        hf_cfg = HFConfig(
            vocab_size=llm_cfg.vocab_size, hidden_size=llm_cfg.hidden_size,
            intermediate_size=llm_cfg.intermediate_size, num_hidden_layers=L,
            num_attention_heads=llm_cfg.num_attention_heads,
            num_key_value_heads=llm_cfg.num_key_value_heads,
            rope_theta=llm_cfg.rope_theta, rms_norm_eps=llm_cfg.rms_norm_eps,
            max_position_embeddings=llm_cfg.max_position_embeddings,
            tie_word_embeddings=llm_cfg.tie_word_embeddings,
            attn_implementation="eager",
        )
        hf = Qwen2ForCausalLM(hf_cfg).eval()
        wanted = set(hf.state_dict())
        sub = {k: v.float() for k, v in state_dict.items() if k in wanted}
        missing = wanted - set(sub)
        if missing:
            report(name, "SKIP", f"checkpoint lacks {sorted(missing)[:3]}...")
            return
        hf.load_state_dict(sub)
        dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
        params = params_from_numpy(convert_qwen2(
            {k: v for k, v in state_dict.items() if k.startswith("model.") or k == "lm_head.weight"},
            llm_cfg), dtype, device)
        rng = np.random.default_rng(0)
        ids = rng.integers(0, min(llm_cfg.vocab_size, 50000), size=(2, 24))
        with torch.no_grad():
            ref = hf(torch.tensor(ids)).logits.numpy()
            ours = qwen2.forward_logits(params, llm_cfg,
                                        torch.tensor(ids, device=device)).cpu().numpy()
        delta = float(np.abs(ours - ref).max())
        scale = float(np.abs(ref).max())
        if delta <= max(1e-2 * scale, args.logit_tol):
            report(name, "PASS", f"{L} layers on {device.type} ({dtype}), max |d logit| = "
                                 f"{delta:.2e} (scale {scale:.1f})")
        else:
            report(name, "FAIL", f"max |d logit| = {delta:.2e} exceeds tolerance")
    except Exception as e:
        report(name, "FAIL", f"crashed: {e!r}")


# ---------------------------------------------------------------------------
# step 3: feature parity
# ---------------------------------------------------------------------------

def step_feature_parity(args, params, config, device):
    name = "3 feature parity"
    if not args.videos_dir or not os.path.isdir(args.videos_dir):
        report(name, "SKIP", "no --videos_dir with raw videos")
        return
    if "vision_tower" not in params:
        report(name, "SKIP", "checkpoint has no vision tower weights")
        return
    feat_dir = os.path.join(args.data_root, args.dataset, "features")
    try:
        import torch

        from blim_tpu_torch.models.umt_vit import UMTImageProcessor
        from blim_tpu_torch.pipelines.extract import make_featurizer, read_frames

        featurize = make_featurizer(params["vision_tower"], config, device=device)
        side = config.vision.image_size
        proc = UMTImageProcessor((side, side))
        lf = config.mm_local_num_frames
        worst, checked = 1.0, 0
        for vp in sorted(glob.glob(os.path.join(args.videos_dir, "*")))[: args.feature_videos]:
            vid = os.path.splitext(os.path.basename(vp))[0]
            ref_path = os.path.join(feat_dir, f"{vid}.pth")
            if not os.path.exists(ref_path):
                continue
            pixels = proc.preprocess(read_frames(vp, num_frames=config.num_clips * lf))
            clips = len(pixels) // lf
            pix = torch.from_numpy(pixels[: clips * lf].reshape(1, clips, lf, *pixels.shape[1:]))
            ours = featurize(pix)[0].float().cpu().numpy()
            ref = torch.load(ref_path, map_location="cpu", weights_only=True).float().numpy()
            a = ours.reshape(-1, ours.shape[-1]).astype(np.float64)
            b = ref.reshape(-1, ref.shape[-1]).astype(np.float64)
            cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
                                     + 1e-9)
            worst = min(worst, float(cos.min()))
            checked += 1
        if not checked:
            report(name, "SKIP", "no videos with matching reference features")
        elif worst > 0.999:
            report(name, "PASS", f"{checked} videos, min token cos-sim {worst:.5f}")
        else:
            report(name, "FAIL", f"min token cos-sim {worst:.5f} <= 0.999")
    except Exception as e:
        report(name, "FAIL", f"crashed: {e!r}")


# ---------------------------------------------------------------------------
# step 4: score parity (zero-shot rerank with the preset fusion weights)
# ---------------------------------------------------------------------------

def step_score_parity(args, params, config, tokenizer, expected, device):
    name = "4 score parity (zero-shot)"
    try:
        from blim_tpu_torch.data.datasets import load_dataset, load_iv2_scores
        from blim_tpu_torch.data.prompts import make_vtg_layout
        from blim_tpu_torch.engine import loop as loop_lib
        from blim_tpu_torch.engine.rerank import RerankEngine
        from blim_tpu_torch.pipelines.configs import ZEROSHOT_PRESETS

        preset = ZEROSHOT_PRESETS[args.dataset]
        feature_shape = (config.num_clips, config.tokens_per_clip, config.mm_hidden_size)
        ds = load_dataset(args.dataset, args.data_root, "test", feature_shape)
        iv2 = load_iv2_scores(args.scores_dir, args.dataset, zeroshot=True)
        layout = make_vtg_layout(tokenizer, args.dataset, config.video_tokens_vtg,
                                 CAPTION_BUDGET[args.dataset])
        engine = RerankEngine(params, config, layout, None, batch_size=args.batch_size_eval,
                              device=device)
        results = loop_lib.val_one_epoch(
            engine, ds, iv2, tokenizer, preset["topk"], preset["cpn"],
            tuple(preset["alpha"]), tuple(preset["c"]), has_tvg=False)
        engine.close()
        blim = results["blim"]
        line = ", ".join(f"{k}={blim[k]:.1f}" for k in
                         ("t2v_r1", "t2v_r5", "v2t_r1", "v2t_r5") if k in blim)
        if not expected or "blim" not in expected:
            report(name, "SKIP", f"computed ({line}) but no --expected to compare "
                                 "(run the torch reference and pass its numbers)")
            return
        bad = [k for k, v in expected["blim"].items()
               if k in blim and abs(blim[k] - v) > args.recall_tol]
        if bad:
            deltas = {k: round(blim[k] - expected["blim"][k], 2) for k in bad}
            report(name, "FAIL", f"outside ±{args.recall_tol}: {deltas} ({line})")
        else:
            report(name, "PASS", f"within ±{args.recall_tol} of reference ({line})")
    except Exception as e:
        report(name, "FAIL", f"crashed: {e!r}")


# ---------------------------------------------------------------------------
# step 5: training trajectory
# ---------------------------------------------------------------------------

def step_train_trajectory(args, params, config, tokenizer, expected, device):
    name = "5 train trajectory"
    try:
        import torch

        from blim_tpu_torch.data.collate import collate_train_batch
        from blim_tpu_torch.data.datasets import TrainLoader, load_dataset
        from blim_tpu_torch.data.prompts import make_tvg_layout, make_vtg_layout
        from blim_tpu_torch.engine import train as train_lib
        from blim_tpu_torch.pipelines.configs import TRAIN_PRESETS

        preset = TRAIN_PRESETS[args.dataset]
        feature_shape = (config.num_clips, config.tokens_per_clip, config.mm_hidden_size)
        ds = load_dataset(args.dataset, args.data_root, "train", feature_shape)
        budget = CAPTION_BUDGET[args.dataset]
        vtg_l = make_vtg_layout(tokenizer, args.dataset, config.video_tokens_vtg, budget)
        tvg_l = make_tvg_layout(tokenizer, config.num_clips, budget)
        tcfg = train_lib.TrainConfig(
            lr=preset["lr"], weight_decay=preset["weight_decay"],
            warmup_epochs=preset["warmup_epochs"], epochs=preset["epochs"], accum_iter=1)
        B = preset["batch_size"]
        trainable = train_lib.init_trainable(
            torch.Generator(device=device).manual_seed(1), config, tcfg,
            visual_head=params["visual_head"]["kernel"])
        state = train_lib.init_train_state(trainable, tcfg, steps_per_epoch=max(len(ds) // B, 1))
        step_fn = train_lib.make_train_step(config, tcfg, vtg_l, tvg_l, device=device)
        feats = ds.load_features()
        vocab = torch.from_numpy(np.asarray(ds.video_vocab(), np.float32)).to(device)
        gen = torch.Generator(device=device).manual_seed(0)
        losses = []
        for i, idx in enumerate(TrainLoader(ds, B, seed=0).batches(0)):
            if i >= args.train_steps:
                break
            batch = collate_train_batch(
                [ds.captions[j] for j in idx], feats[ds.item_video_idx[idx]],
                ds.item_video_idx[idx], tokenizer, args.dataset, vtg_l, tvg_l)
            state, metrics = step_fn(state, params, batch, vocab, gen)
            losses.append(float(metrics["loss"]))
        ok = bool(losses) and all(np.isfinite(losses))
        half = max(len(losses) // 2, 1)
        trend_down = np.mean(losses[:half]) > np.mean(losses[-half:])
        detail = f"{len(losses)} steps, loss {losses[0]:.3f} -> {losses[-1]:.3f}"
        if expected and "train_losses" in expected:
            ref = np.asarray(expected["train_losses"][: len(losses)])
            d = float(np.abs(np.asarray(losses[: len(ref)]) - ref).max())
            detail += f", max |d loss| vs reference = {d:.3f}"
            ok = ok and d < args.loss_tol
        # the trend needs enough steps to clear the lr warmup ramp
        if ok and (trend_down or len(losses) < 20):
            report(name, "PASS", detail)
        elif ok:
            report(name, "FAIL", detail + " (no downward trend)")
        else:
            report(name, "FAIL", detail + " (non-finite or off-reference)")
    except Exception as e:
        report(name, "FAIL", f"crashed: {e!r}")


# ---------------------------------------------------------------------------
# synthetic self-test artifacts
# ---------------------------------------------------------------------------

def synthetic_config(device):
    """The full Qwen2 vocabulary (the byte tokenizer emits the real special
    ids, 151645 <|im_end|> and up); on the card head dim 128, which the
    flash kernels take, else the tests' tiny config."""
    from blim_tpu_torch.core.config import tiny_model_config

    if device.type == "cuda":
        return tiny_model_config(vocab_size=152064, hidden_size=256, num_attention_heads=2,
                                 num_key_value_heads=1, intermediate_size=512)
    return tiny_model_config(vocab_size=152064)


def make_synthetic(args, tmp, config):
    """A tiny checkpoint (an HF-named pytorch_model.bin), a dataset of 12
    items (annotations and fp16 features) and InternVideo2 score matrices
    under `tmp`, so that every step can run; sets args' paths."""
    import torch

    from blim_tpu_torch.data.datasets import ANNOTATION_FILES

    rng = np.random.default_rng(0)
    llm = config.llm
    h, i, L = llm.hidden_size, llm.intermediate_size, llm.num_hidden_layers
    nh, nkv, hd = llm.num_attention_heads, llm.num_key_value_heads, llm.head_dim
    mm = config.mm_hidden_size

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.02)

    sd = {"model.embed_tokens.weight": t(llm.vocab_size, h),
          "lm_head.weight": t(llm.vocab_size, h), "model.norm.weight": torch.ones(h)}
    for layer in range(L):
        p = f"model.layers.{layer}."
        sd[p + "input_layernorm.weight"] = torch.ones(h)
        sd[p + "post_attention_layernorm.weight"] = torch.ones(h)
        for proj, rows in (("q_proj", nh * hd), ("k_proj", nkv * hd), ("v_proj", nkv * hd)):
            sd[p + f"self_attn.{proj}.weight"] = t(rows, h)
            sd[p + f"self_attn.{proj}.bias"] = t(rows)
        sd[p + "self_attn.o_proj.weight"] = t(h, nh * hd)
        sd[p + "mlp.gate_proj.weight"] = t(i, h)
        sd[p + "mlp.up_proj.weight"] = t(i, h)
        sd[p + "mlp.down_proj.weight"] = t(h, i)
    for mlp in ("mlp", "tvg_mlp"):
        sd[f"model.mm_projector.{mlp}.0.weight"] = t(h, mm)
        sd[f"model.mm_projector.{mlp}.0.bias"] = t(h)
        sd[f"model.mm_projector.{mlp}.2.weight"] = t(h, h)
        sd[f"model.mm_projector.{mlp}.2.bias"] = t(h)
    sd["visual_head.weight"] = t(mm, h)
    model_path = os.path.join(tmp, "ckpt")
    os.makedirs(model_path)
    torch.save(sd, os.path.join(model_path, "pytorch_model.bin"))

    n = 12
    data_root = os.path.join(tmp, "data")
    ds_dir = os.path.join(data_root, args.dataset)
    feat_dir = os.path.join(ds_dir, "features")
    os.makedirs(feat_dir)
    words = ["man", "dog", "runs", "park", "sings", "car", "cooks", "kitchen"]
    annos = []
    for k in range(n):
        annos.append({"video": f"video{k}.mp4", "caption": " ".join(rng.choice(words, size=3))})
        np.save(os.path.join(feat_dir, f"video{k}.npy"), rng.standard_normal(
            (config.num_clips, config.tokens_per_clip, mm)).astype(np.float16))
    for split in ("train", "test"):
        with open(os.path.join(ds_dir, ANNOTATION_FILES[args.dataset][split]), "w") as f:
            json.dump(annos, f)
    scores_dir = os.path.join(tmp, "scores")
    os.makedirs(scores_dir)
    iv2 = rng.standard_normal((n, n)).astype(np.float32)
    for suffix in ("_zeroshot", ""):
        np.savez(os.path.join(scores_dir, f"{args.dataset.lower()}{suffix}.npz"),
                 t2v=iv2, v2t=iv2.T.copy())
    args.model_path, args.data_root, args.scores_dir = model_path, data_root, scores_dir


def get_args_parser():
    ap = argparse.ArgumentParser("parity_torch")
    ap.add_argument("--model_path", default="./pretrained/VideoChat-Flash-Qwen2-7B_res448")
    ap.add_argument("--data_root", default="./data")
    ap.add_argument("--scores_dir", default="./scores")
    ap.add_argument("--dataset", default="MSRVTT", choices=sorted(CAPTION_BUDGET))
    ap.add_argument("--reference", default="./reference",
                    help="checkout of the PyTorch reference (step 1's oracle)")
    ap.add_argument("--videos_dir", default="", help="raw videos for step 3")
    ap.add_argument("--expected", default="", help="json with the reference's numbers")
    ap.add_argument("--captions", type=int, default=100, help="step 1's sample size")
    ap.add_argument("--logit_layers", type=int, default=4,
                    help="decoder layers compared in step 2 (bounds host memory); 0 = all")
    ap.add_argument("--logit_tol", type=float, default=5e-2)
    ap.add_argument("--feature_videos", type=int, default=4)
    ap.add_argument("--batch_size_eval", type=int, default=16)
    ap.add_argument("--recall_tol", type=float, default=0.2)
    ap.add_argument("--loss_tol", type=float, default=0.05)
    ap.add_argument("--train_steps", type=int, default=8)
    ap.add_argument("--synthetic", action="store_true",
                    help="self-test: a tiny model and synthetic artifacts in a temporary dir")
    ap.add_argument("--steps", default="12345", help="the steps to run")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> int:
    """Runs the steps and prints the summary and the kernels' launch
    counts; returns 1 iff a step FAILed."""
    args = get_args_parser().parse_args(argv)
    RESULTS.clear()
    import torch

    from blim_tpu_torch.checkpoints.convert import load_hf_state_dict, load_videochat_flash
    from blim_tpu_torch.core.config import load_model_config
    from blim_tpu_torch.core.device import resolve_device
    from blim_tpu_torch.data.datasets import load_dataset
    from blim_tpu_torch.data.tokenization import load_tokenizer
    from blim_tpu_torch.kernels import flash_attention as fa

    device = resolve_device(args.device)
    fa.reset_counts()
    tmp_ctx = tempfile.TemporaryDirectory() if args.synthetic else None
    config = None
    if args.synthetic:
        config = synthetic_config(device)
        make_synthetic(args, tmp_ctx.name, config)
    try:
        tokenizer = load_tokenizer(args.model_path)
        expected = json.load(open(args.expected)) if args.expected else None
        params = None
        if os.path.isdir(args.model_path):
            try:
                if config is None:
                    config = load_model_config(args.model_path)
                dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
                params = load_videochat_flash(args.model_path, config, dtype=dtype,
                                              device=device)
            except Exception as e:
                report("checkpoint load", "SKIP", f"{e!r}")
                params = None

        # step 1's captions: the dataset's when it loads, else made up
        captions = None
        if config is not None:
            try:
                fs = (config.num_clips, config.tokens_per_clip, config.mm_hidden_size)
                captions = load_dataset(args.dataset, args.data_root, "test",
                                        fs).captions[: args.captions]
            except Exception:
                captions = None
        if captions is None:
            rng = np.random.default_rng(1)
            words = ["a", "man", "sings", "on", "stage", "dog", "park", "cooking"]
            captions = [" ".join(rng.choice(words, size=rng.integers(3, 8)))
                        for _ in range(min(args.captions, 25))]

        if "1" in args.steps:
            step_tokenizer_goldens(args, tokenizer, captions)
        if "2" in args.steps:
            if params is not None:
                step_logit_parity(args, load_hf_state_dict(args.model_path), config, device)
            else:
                report("2 logit parity", "SKIP", f"no checkpoint at {args.model_path}")
        for step, label, fn, extra in (
                ("3", "3 feature parity", step_feature_parity, ()),
                ("4", "4 score parity (zero-shot)", step_score_parity, (tokenizer, expected)),
                ("5", "5 train trajectory", step_train_trajectory, (tokenizer, expected))):
            if step not in args.steps:
                continue
            if params is None:
                report(label, "SKIP", "no checkpoint")
            else:
                fn(args, params, config, *extra, device)
    finally:
        if tmp_ctx:
            tmp_ctx.cleanup()

    print("\n== parity summary ==")
    for step, status, _detail in RESULTS:
        print(f"  {status:4s}  {step}")
    print(f"launches: {json.dumps(fa.counts())}", flush=True)
    return 1 if any(s == "FAIL" for _, s, _ in RESULTS) else 0


if __name__ == "__main__":
    sys.exit(main())
