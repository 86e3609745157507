"""Published run configurations (copy of blim_tpu/pipelines/configs.py).

The tuned hyperparameters of the published BLiM runs (its README commands)
as data. `apply_preset` fills an argparse namespace for `pipelines.main`.
"""

from __future__ import annotations

from typing import Any, Dict

# Fine-tuning configs: 8-GPU global batches.
TRAIN_PRESETS: Dict[str, Dict[str, Any]] = {
    "DiDeMo": dict(batch_size=4, batch_size_eval=16, epochs=5, warmup_epochs=1,
                   lr=2e-4, weight_decay=1.0, accum_iter=1, topk=16, cpn=True,
                   alpha=[0.0, 0.8], c=[0.9, 0.2, 0.9, 0.9]),
    "ActivityNet": dict(batch_size=2, batch_size_eval=16, epochs=5, warmup_epochs=1,
                        lr=2e-4, weight_decay=1.0, accum_iter=2, topk=16, cpn=True,
                        alpha=[0.2, 0.9], c=[1.0, 0.4, 0.9, 0.8]),
    "LSMDC": dict(batch_size=4, batch_size_eval=16, epochs=3, warmup_epochs=1,
                  lr=1e-4, weight_decay=1.0, accum_iter=8, topk=16, cpn=True,
                  alpha=[0.2, 1.0], c=[1.0, 0.6, 0.9, 0.6]),
    "MSRVTT": dict(batch_size=4, batch_size_eval=16, epochs=3, warmup_epochs=1,
                   lr=1e-4, weight_decay=1.0, accum_iter=16, topk=16, cpn=True,
                   alpha=[0.0, 0.9], c=[1.0, 0.6, 0.8, 0.4]),
}

# Zero-shot eval fusion weights.
ZEROSHOT_PRESETS: Dict[str, Dict[str, Any]] = {
    "DiDeMo": dict(topk=16, cpn=True, alpha=[0.0, 0.9], c=[1.0, 0.0, 0.9, 0.9]),
    "ActivityNet": dict(topk=16, cpn=True, alpha=[0.0, 0.9], c=[1.0, 0.0, 0.9, 0.8]),
    "LSMDC": dict(topk=16, cpn=True, alpha=[0.0, 0.9], c=[1.0, 0.0, 0.9, 0.8]),
    "MSRVTT": dict(topk=16, cpn=True, alpha=[0.0, 0.8], c=[1.0, 0.0, 0.8, 0.6]),
}


def apply_preset(args, zeroshot: bool = False):
    """Overlay the dataset's published preset onto parsed args."""
    presets = ZEROSHOT_PRESETS if zeroshot else TRAIN_PRESETS
    for key, value in presets[args.dataset].items():
        setattr(args, key, value)
    return args
