"""LoRA fine-tuning on one GPU (port of blim_tpu/engine/train.py).

  * trainable subset = LoRA adapters (LLM q/k/v/o + lm_head, projector MLPs)
    + the fp32 `visual_head`, all fp32 leaf tensors; the frozen 7B needs no
    gradient, so its backward computes activation gradients only;
  * loss = VTG caption CE + TVG clip CE, each direction a per-layer
    checkpointed decoder forward whose attention runs the B1-lse forward
    and the B3/B4 backward kernels on the card;
  * AdamW betas (0.9, 0.95), eps 1e-8, no weight decay on 1-D leaves, and
    the per-iteration half-cosine warmup schedule. One torch AdamW update,
    p (1 - lr wd) - lr adam, equals the JAX chain's -lr (adam + wd p);
  * gradient accumulation in place of optax.MultiSteps: the mean of
    `accum_iter` micro-step gradients, and the schedule counts applied
    updates, as MultiSteps' inner state does.

The multi-GPU mesh and sharded frozen weights of the JAX package are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from blim_tpu_torch.adapters import lora as lora_lib
from blim_tpu_torch.core.config import ModelConfig
from blim_tpu_torch.core.device import DeviceLike, resolve_device
from blim_tpu_torch.data.prompts import TVGLayout, VTGLayout
from blim_tpu_torch.models import videochat_flash as vcf
from blim_tpu_torch.scoring import criteria

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 2e-4
    min_lr: float = 0.0
    weight_decay: float = 1.0
    warmup_epochs: float = 1.0
    epochs: int = 5
    accum_iter: int = 1
    lora: lora_lib.LoraConfig = dataclasses.field(default_factory=lora_lib.LoraConfig)


def cosine_lr(epoch_frac: float, cfg: TrainConfig) -> float:
    """Per-iteration linear warmup -> half-cosine decay on fractional epochs."""
    if epoch_frac < cfg.warmup_epochs:
        return cfg.lr * epoch_frac / max(cfg.warmup_epochs, 1e-8)
    denom = max(cfg.epochs - cfg.warmup_epochs, 1e-8)
    return cfg.min_lr + (cfg.lr - cfg.min_lr) * 0.5 * (
        1.0 + math.cos(math.pi * (epoch_frac - cfg.warmup_epochs) / denom))


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [] if tree is None else [tree]


def init_trainable(gen: torch.Generator, config: ModelConfig, cfg: TrainConfig,
                   visual_head: torch.Tensor) -> Params:
    """The trainable tree, seeded from `gen` on its device: LoRA factors
    (B = 0) + visual_head, every leaf fp32 and requiring grad."""
    tree = {
        "lora": {
            "llm": lora_lib.init_llm_lora(gen, config.llm, cfg.lora),
            "projector": lora_lib.init_projector_lora(
                gen, config.mm_hidden_size, config.llm.hidden_size, cfg.lora),
        },
        "visual_head": {"kernel": visual_head.detach().to(gen.device, torch.float32).clone()},
    }
    for t in _leaves(tree):
        t.requires_grad_(True)
    return tree


def decay_mask(trainable: Params) -> Params:
    """No weight decay for 1-D leaves (timm param_groups_weight_decay)."""
    if isinstance(trainable, dict):
        return {k: decay_mask(v) for k, v in trainable.items()}
    return trainable.ndim > 1


def make_optimizer(trainable: Params, cfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW over the trainable leaves in two groups, decay (ndim > 1) and
    none; the train step sets the lr of both before every applied update."""
    pairs = list(zip(_leaves(trainable), _leaves(decay_mask(trainable))))
    groups = [{"params": [p for p, d in pairs if d], "weight_decay": cfg.weight_decay},
              {"params": [p for p, d in pairs if not d], "weight_decay": 0.0}]
    return torch.optim.AdamW([g for g in groups if g["params"]], lr=cfg.lr, betas=(0.9, 0.95),
                             eps=1e-8)


@dataclasses.dataclass
class TrainState:
    trainable: Params
    optimizer: torch.optim.Optimizer
    steps_per_epoch: int
    step: int = 0       # micro-steps taken
    applied: int = 0    # optimizer updates applied: the schedule's count


def init_train_state(trainable: Params, cfg: TrainConfig, steps_per_epoch: int) -> TrainState:
    return TrainState(trainable, make_optimizer(trainable, cfg), steps_per_epoch)


def loss_fn(
    trainable: Params,
    frozen: Params,
    config: ModelConfig,
    batch: Dict[str, torch.Tensor],
    video_vocab: torch.Tensor,
    vtg_geom: Tuple[int, int, int],   # (video_start, window_start, window_len)
    tvg_geom: Tuple[int, int],        # (video_start, gather_start)
    lora_scale: float,
    generator: Optional[torch.Generator] = None,
    lora_dropout: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """VTG caption CE + TVG clip CE, both directions checkpointed per layer."""
    params = dict(frozen)
    params["visual_head"] = trainable["visual_head"]
    lora = trainable["lora"]
    drop = dict(generator=generator, lora_dropout=lora_dropout, remat=True)

    v_start, w_start, w_len = vtg_geom
    hidden = vcf.vtg_hidden(params, config, batch["vtg_input_ids"], batch["vtg_attention_mask"],
                            batch["video"], v_start, lora=lora, lora_scale=lora_scale, **drop)
    logits = vcf.vtg_window_logits(params, config, hidden, w_start, w_len, lora, lora_scale)
    vtg_loss = criteria.vtg_train_loss(logits, batch["vtg_window_labels"])

    t_start, g_start = tvg_geom
    hidden = vcf.tvg_hidden(params, config, batch["tvg_input_ids"], batch["tvg_attention_mask"],
                            batch["video"], t_start, lora=lora, lora_scale=lora_scale, **drop)
    clip_hidden = hidden[:, g_start: g_start + config.num_clips]
    clip_logits = criteria.tvg_clip_logits(clip_hidden, trainable["visual_head"]["kernel"],
                                           video_vocab)
    tvg_loss = criteria.tvg_train_loss(clip_logits, batch["video_label"])

    loss = vtg_loss + tvg_loss
    return loss, {"loss": loss, "vtg_loss": vtg_loss, "tvg_loss": tvg_loss}


def make_train_step(config: ModelConfig, train_cfg: TrainConfig, vtg_layout: VTGLayout,
                    tvg_layout: TVGLayout, device: DeviceLike = "cuda"):
    """Returns step(state, frozen, batch, video_vocab, generator) -> (state,
    metrics). The batch (collate_train_batch's arrays, or tensors) moves to
    the device; the video features take the projector's dtype. The state is
    updated in place and returned. Metrics: loss, vtg_loss, tvg_loss and
    grad_norm (the global norm of this micro-step's gradients), as 0-d
    tensors on the device."""
    dev = resolve_device(device)
    ws, wl = vtg_layout.label_window
    vtg_geom = (vtg_layout.video_start, ws, wl)
    tvg_geom = (tvg_layout.video_start, int(tvg_layout.gather_positions[0]))
    scale = train_cfg.lora.scale
    accum = max(train_cfg.accum_iter, 1)

    def step(state: TrainState, frozen: Params, batch, video_vocab, generator=None):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        batch["video"] = batch["video"].to(frozen["projector"]["mlp"]["fc1"]["kernel"].dtype)
        leaves = _leaves(state.trainable)
        loss, metrics = loss_fn(state.trainable, frozen, config, batch,
                                torch.as_tensor(video_vocab, device=dev), vtg_geom, tvg_geom,
                                scale, generator, train_cfg.lora.dropout)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        grad_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                          for g in grads]))
        for p, g in zip(leaves, grads):
            p.grad = g if p.grad is None else p.grad.add_(g)
        state.step += 1
        if state.step % accum == 0:
            if accum > 1:
                for p in leaves:
                    p.grad.div_(accum)
            lr = cosine_lr(state.applied / max(state.steps_per_epoch, 1), train_cfg)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
            state.applied += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm.detach()
        return state, metrics

    return step
