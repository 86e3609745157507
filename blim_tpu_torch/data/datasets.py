"""Retrieval dataset surface of the train loop (copy of the JAX-free part of
blim_tpu/data/datasets.py).

`RetrievalDataset` here holds only what `engine/loop.train_one_epoch`
reads: the dataset name, the per-item captions and the item -> video-vocab
index. Annotation parsing, the feature store and `load_dataset` join the
port with the pipelines.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class RetrievalDataset:
    name: str                      # MSRVTT | DiDeMo | ActivityNet | LSMDC
    captions: List[str]            # per-item caption
    item_video_idx: np.ndarray     # (N,) item -> vocab index

    def __len__(self) -> int:
        return len(self.captions)


class TrainLoader:
    """Shuffled, epoch-seeded, per-process-sharded batch iterator (the
    DistributedSampler analogue)."""

    def __init__(
        self,
        dataset: RetrievalDataset,
        batch_size: int,
        seed: int = 0,
        num_shards: int = 1,
        shard: int = 0,
        drop_last: bool = False,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_shards = num_shards
        self.shard = shard
        self.drop_last = drop_last

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(len(self.ds))
        # pad to a multiple of shards like DistributedSampler
        total = -(-len(order) // self.num_shards) * self.num_shards
        order = np.concatenate([order, order[: total - len(order)]])
        return order[self.shard:: self.num_shards]

    def __len__(self) -> int:
        per_shard = -(-len(self.ds) // self.num_shards)
        if self.drop_last:
            return per_shard // self.batch_size
        return -(-per_shard // self.batch_size)

    def batches(self, epoch: int):
        """Fixed-size batches; the final partial batch is padded by wrapping
        (the same repeat-padding DistributedSampler applies across ranks), so
        every step has the same shape."""
        idx = self.epoch_indices(epoch)
        for s in range(0, len(idx), self.batch_size):
            chunk = idx[s: s + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    return
                # cyclic repeat covers datasets smaller than one batch too
                chunk = np.concatenate([chunk, np.resize(idx, self.batch_size - len(chunk))])
            yield chunk
