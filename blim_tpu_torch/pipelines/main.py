"""Train / eval CLI, one GPU a process (port of blim_tpu/pipelines/main.py).

The same flags and run flow: build the model and tokenizer, install LoRA,
then either evaluate (zero-shot, or fine-tuned with --resume) with the
alpha/c fusion weights, or train epochs with an eval after each, saving
every epoch and keeping the best on t2v_r1 + v2t_r1.

Usage (fine-tuned eval of a trained state on a checkpoint directory):
    python -m blim_tpu_torch.pipelines.main --dataset MSRVTT --eval \\
        --model_path ./pretrained/VideoChat-Flash-Qwen2-7B_res448 \\
        --resume ./checkpoint/checkpoint_best --topk 16 --cpn \\
        --alpha 0.0 0.9 --c 1.0 0.6 0.8 0.4

The checkpoint directory (`config.json` plus safetensors shards or
pytorch_model*.bin) must be on local disk. Without one the model is the
random 7B, made from --seed on the card (pipeline smoke mode: the scores
mean nothing, and a warning says so). Weights are bf16 on the card and
fp32 on the CPU (--device cpu); visual_head and the LoRA factors are fp32
on both. `main` returns the last results dict (the eval's, or the last
epoch's eval when training).

Data parallel under `torchrun` (or any launcher that sets RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT): one process a GPU,
NCCL on the card and gloo with --device cpu; each rank runs on
cuda:LOCAL_RANK, draws its LoRA dropout from --seed + rank, trains on its
shard of every epoch's shuffle (one order from --seed) with the gradients
averaged over the ranks, and scores its shard of the rerank packs; only
rank 0 prints and writes logs and checkpoints:
    torchrun --nproc_per_node 8 -m blim_tpu_torch.pipelines.main ...

--profile_dir DIR traces the evaluation with torch.profiler into
DIR/trace.json (a Chrome trace; trace_rank<r>.json a rank in a group of
several), as the JAX CLI traces it with jax.profiler, with the program's
tracer on, so the trace names the evaluation's spans. Left out:
--mesh_model (tensor parallelism over a TPU mesh).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

import numpy as np


def get_args_parser():
    parser = argparse.ArgumentParser("BLiM-torch", add_help=False)
    parser.add_argument("--batch_size", default=4, type=int, help="train batch per process")
    parser.add_argument("--batch_size_eval", default=16, type=int,
                        help="pairs a step of the naive per-pair schedule (the packed passes "
                             "size their steps by a token budget)")
    parser.add_argument("--epochs", default=5, type=int)
    parser.add_argument("--accum_iter", default=1, type=int)
    parser.add_argument("--model_path", default="./pretrained/VideoChat-Flash-Qwen2-7B_res448", type=str)

    parser.add_argument("--weight_decay", type=float, default=1.0)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--min_lr", type=float, default=0.0)
    parser.add_argument("--warmup_epochs", type=float, default=1)

    parser.add_argument("--dataset", default="DiDeMo", type=str,
                        choices=["DiDeMo", "ActivityNet", "LSMDC", "MSRVTT"])
    parser.add_argument("--data_root", default="./data", type=str)
    parser.add_argument("--scores_dir", default="./scores", type=str)
    parser.add_argument("--output_dir", default="./checkpoint")
    parser.add_argument("--num_clips", default=4, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--resume", default="", help="resume from checkpoint")
    parser.add_argument("--start_epoch", default=0, type=int)
    parser.add_argument("--max_caption_tokens", default=0, type=int,
                        help="caption token budget; 0 = per-dataset default "
                             "(MSRVTT/LSMDC 96, DiDeMo 160, ActivityNet 256 — "
                             "paragraph captions need headroom)")

    parser.add_argument("--lora_r", type=int, default=8)
    parser.add_argument("--lora_alpha", type=int, default=32)
    parser.add_argument("--lora_drop", type=float, default=0.05)

    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--topk", type=int, default=10)
    parser.add_argument("--cpn", action="store_true")
    parser.add_argument("--alpha", nargs="+", type=float, default=[0.0, 0.0])
    parser.add_argument("--c", nargs="+", type=float, default=[0.0, 0.0, 0.0, 0.0])

    parser.add_argument("--preset", action="store_true",
                        help="apply the dataset's published hyperparameters")
    parser.add_argument("--tiny", action="store_true", help="tiny random model (smoke tests)")
    parser.add_argument("--profile_dir", default=None,
                        help="torch.profiler trace of the evaluation, DIR/trace.json")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a GPU) or 'cpu' (plain versions)")
    return parser


def main(args):
    import torch

    from blim_tpu_torch.adapters.lora import LoraConfig
    from blim_tpu_torch.checkpoints import state_io
    from blim_tpu_torch.checkpoints.convert import init_params, load_videochat_flash
    from blim_tpu_torch.core.config import ModelConfig, load_model_config, tiny_model_config
    from blim_tpu_torch.data.datasets import TrainLoader, load_dataset, load_iv2_scores
    from blim_tpu_torch.data.prompts import make_tvg_layout, make_vtg_layout
    from blim_tpu_torch.data.tokenization import load_tokenizer
    from blim_tpu_torch.engine import loop as loop_lib
    from blim_tpu_torch.engine import train as train_lib
    from blim_tpu_torch.engine.rerank import RerankEngine
    from blim_tpu_torch.utils import distributed as dist
    from blim_tpu_torch.utils.profiling import trace

    dev = dist.device_for_rank(args.device)
    if getattr(args, "preset", False):
        from blim_tpu_torch.pipelines.configs import apply_preset

        apply_preset(args, zeroshot=args.eval and not args.resume)

    dist.init_distributed_mode(device=dev)
    print(f"job dir: {os.path.dirname(os.path.realpath(__file__))}")
    print(str(args).replace(", ", ",\n"))
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)

    seed = args.seed + dist.get_rank()
    np.random.seed(seed)
    torch.manual_seed(seed)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32

    # ---- model + tokenizer --------------------------------------------------
    tokenizer = load_tokenizer(args.model_path)
    have_ckpt = os.path.isdir(args.model_path) and os.path.exists(
        os.path.join(args.model_path, "config.json")
    )
    if args.tiny:
        config = tiny_model_config(vocab_size=152064)
        params = init_params(config, seed=args.seed, dtype=dtype, device=dev)
    elif have_ckpt:
        config = load_model_config(args.model_path)
        t0 = time.time()
        params = load_videochat_flash(args.model_path, config, dtype=dtype, device=dev)
        print(f"loaded {args.model_path} in {time.time() - t0:.1f}s")
    else:
        print(f"WARNING: no checkpoint at {args.model_path}; random 7B weights "
              "(pipeline smoke mode, accuracy is meaningless)")
        config = ModelConfig()
        params = init_params(config, seed=args.seed, dtype=dtype, device=dev)

    lora_cfg = LoraConfig(r=args.lora_r, alpha=args.lora_alpha, dropout=args.lora_drop)
    train_cfg = train_lib.TrainConfig(
        lr=args.lr, min_lr=args.min_lr, weight_decay=args.weight_decay,
        warmup_epochs=args.warmup_epochs, epochs=args.epochs,
        accum_iter=args.accum_iter, lora=lora_cfg,
    )
    trainable = train_lib.init_trainable(
        torch.Generator(device=dev).manual_seed(args.seed + 1), config, train_cfg,
        visual_head=params["visual_head"]["kernel"],
    )
    n_trainable = state_io.count_params(trainable)
    n_total = state_io.count_params(params)
    print("*" * 80)
    print(f"Total params: {n_total:,}")
    print(f"Trainable params: {n_trainable:,}")
    print("*" * 80)

    # ---- data ----------------------------------------------------------------
    feature_shape = (config.num_clips, config.tokens_per_clip, config.mm_hidden_size)
    dataset_val = load_dataset(args.dataset, args.data_root, "test", feature_shape)
    if not args.eval:
        dataset_train = load_dataset(args.dataset, args.data_root, "train", feature_shape)

    cap_budget = args.max_caption_tokens or {
        "MSRVTT": 96, "LSMDC": 96, "DiDeMo": 160, "ActivityNet": 256
    }[args.dataset]
    vtg_layout = make_vtg_layout(tokenizer, args.dataset, config.video_tokens_vtg, cap_budget)
    tvg_layout = make_tvg_layout(tokenizer, config.num_clips, cap_budget)

    # ---- optimizer + resume ----------------------------------------------------
    if not args.eval:
        steps_per_epoch = max(len(dataset_train) // (args.batch_size * dist.get_world_size()), 1)
    else:
        steps_per_epoch = 1
    optimizer = train_lib.make_optimizer(trainable, train_cfg)
    if args.resume:
        loaded, opt_restored, epoch0 = state_io.load_checkpoint(args.resume, trainable)
        state_io.assign_trainable(trainable, loaded)
        if opt_restored is not None and not args.eval:
            optimizer.load_state_dict(opt_restored)
        if not args.eval:
            args.start_epoch = epoch0 + 1
        print(f"resumed from {args.resume} (epoch {epoch0})")
    train_lib.broadcast_trainable(trainable)   # every rank starts from rank 0's tree

    has_tvg = args.resume != "" or not args.eval

    # one engine for the run; each eval swaps in the trainable tree as it is then
    engine = RerankEngine(params, config, vtg_layout, tvg_layout, lora_scale=lora_cfg.scale,
                          batch_size=args.batch_size_eval, device=dev)

    def run_eval():
        engine.set_trainable(trainable["lora"] if has_tvg else None,
                             trainable["visual_head"]["kernel"])
        iv2 = load_iv2_scores(args.scores_dir, args.dataset, zeroshot=not has_tvg)
        return loop_lib.val_one_epoch(
            engine, dataset_val, iv2, tokenizer, args.topk, args.cpn,
            tuple(args.alpha), tuple(args.c), has_tvg,
        )

    start_time = time.time()
    if args.eval:
        # one file a rank in a group of several
        trace_name = (f"trace_rank{dist.get_rank()}.json" if dist.get_world_size() > 1
                      else "trace.json")
        with trace(args.profile_dir, trace_name):
            results = run_eval()
        table = loop_lib.results_table(results)
        if args.output_dir and dist.is_main_process():
            with open(os.path.join(args.output_dir, "log.txt"), "a", encoding="utf-8") as f:
                f.write("\n\n" + table)
        print("\n" + table)
        return results

    # ---- training ---------------------------------------------------------------
    first = args.start_epoch * steps_per_epoch
    state = train_lib.TrainState(trainable, optimizer, steps_per_epoch, step=first,
                                 applied=first // max(args.accum_iter, 1))
    step_fn = train_lib.make_train_step(config, train_cfg, vtg_layout, tvg_layout, device=dev)
    features_train = dataset_train.load_features()
    video_vocab = torch.from_numpy(np.asarray(dataset_train.video_vocab(), np.float32)).to(dev)
    loader = TrainLoader(
        dataset_train, args.batch_size, seed=args.seed,
        num_shards=dist.get_world_size(), shard=dist.get_rank(),
    )

    best_r1 = 0.0
    results = None
    print(f"Start training for {args.epochs} epochs")
    for epoch in range(args.start_epoch, args.epochs):
        state, train_stats = loop_lib.train_one_epoch(
            state, step_fn, params, dataset_train, loader, features_train,
            video_vocab, tokenizer, vtg_layout, tvg_layout, epoch,
            generator=torch.Generator(device=dev).manual_seed(seed * 1000 + epoch), device=dev,
        )
        # every rank calls save_checkpoint: rank 0 writes, all wait for it
        if args.output_dir:
            state_io.save_checkpoint(
                args.output_dir, f"epoch{epoch}", trainable, optimizer, epoch, vars(args)
            )

        results = run_eval()   # the same on every rank (merged scores)
        cur_r1 = results["blim"]["t2v_r1"] + results["blim"]["v2t_r1"]
        if args.output_dir and best_r1 < cur_r1:
            best_r1 = cur_r1
            state_io.save_checkpoint(
                args.output_dir, "checkpoint_best", trainable, optimizer, epoch, vars(args)
            )
        if dist.is_main_process():
            log_stats = {
                "epoch": epoch,
                **{f"train_{k}": v for k, v in train_stats.items()},
                **{f"val_{k}": v for k, v in results.items()},
            }
            if args.output_dir:
                with open(os.path.join(args.output_dir, "log.txt"), "a", encoding="utf-8") as f:
                    f.write(json.dumps(log_stats) + "\n")
                    f.write(loop_lib.results_table(results) + "\n")
            print("\n" + loop_lib.results_table(results))

    total = str(datetime.timedelta(seconds=int(time.time() - start_time)))
    print(f"Training time {total}")
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser("BLiM-torch", parents=[get_args_parser()])
    main(parser.parse_args())
