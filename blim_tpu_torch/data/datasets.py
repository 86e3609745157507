"""Retrieval datasets (copy of the JAX-free part of
blim_tpu/data/datasets.py).

Annotation parsing and caption normalization for MSRVTT / DiDeMo /
ActivityNet / LSMDC, the InternVideo2 score loader, and the train loader. A
dataset is a flat item table plus a FeatureStore; batching into the static
layouts happens in data/collate.py and engine/rerank.py.

`RetrievalDataset`'s first three fields are the ones the train loop reads
(name, captions, item -> video-vocab index), so `RetrievalDataset(name,
captions, item_video_idx)` builds a loop-only dataset; `load_dataset` fills
the rest.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from blim_tpu_torch.data.features import FeatureStore


@dataclasses.dataclass
class RetrievalDataset:
    name: str                      # MSRVTT | DiDeMo | ActivityNet | LSMDC
    captions: List[str]            # per-item caption
    item_video_idx: np.ndarray     # (N,) item -> vocab index
    split: str = ""                # train | test
    vids: List[str] = dataclasses.field(default_factory=list)        # per-item video id
    store: Optional[FeatureStore] = None
    vocab_vids: List[str] = dataclasses.field(default_factory=list)  # sorted unique vids

    def __len__(self) -> int:
        return len(self.captions)

    def load_features(self) -> np.ndarray:
        """(V, clips, tokens, mm) features for the video vocabulary."""
        return self.store.load_many(self.vocab_vids)

    def video_vocab(self) -> np.ndarray:
        """Mean-pooled (V, clips, mm) vocabulary: the mean over the token
        axis of the raw features."""
        return self.load_features().mean(axis=2)

    @property
    def video_labels(self) -> np.ndarray:
        """Per-item true-video vocab index."""
        return self.item_video_idx


def _vid_from_path(name: str, video: str) -> str:
    if name == "LSMDC":
        # nested "dir/file.avi" -> file
        return video[:-4].split("/")[1]
    return video.split(".")[0]


def _caption(name: str, caption) -> str:
    if name == "DiDeMo":
        return (" ".join(caption)).strip()    # a list of sentences joined with a space
    if name == "ActivityNet":
        return ("".join(caption)).strip()     # a list of sentences joined with ""
    return str(caption).strip()


ANNOTATION_FILES = {
    "MSRVTT": {"train": "msrvtt_ret_train.json", "test": "msrvtt_ret_test.json"},
    "DiDeMo": {"train": "didemo_ret_train.json", "test": "didemo_ret_test.json"},
    "ActivityNet": {"train": "anet_ret_train.json", "test": "anet_ret_val_1.json"},
    "LSMDC": {"train": "lsmdc_ret_train.json", "test": "lsmdc_ret_test_1000.json"},
}

DATASETS = tuple(ANNOTATION_FILES)


def load_dataset(
    name: str,
    data_root: str,
    split: str,
    feature_shape: Tuple[int, int, int] = (4, 64, 1024),
) -> RetrievalDataset:
    """{data_root}/{name}/{annotation file} + {data_root}/{name}/features ->
    the dataset. The train split keeps only items whose features exist; the
    test split keeps all (missing features read as zeros)."""
    if name not in ANNOTATION_FILES:
        raise ValueError(f"unknown dataset {name}; choose from {DATASETS}")
    ds_root = os.path.join(data_root, name)
    anno_path = os.path.join(ds_root, ANNOTATION_FILES[name][split])
    with open(anno_path) as f:
        annotations = json.load(f)

    store = FeatureStore(os.path.join(ds_root, "features"), shape=feature_shape)
    vids: List[str] = []
    captions: List[str] = []
    for anno in annotations:
        vid = _vid_from_path(name, anno["video"])
        if split == "test" or store.available(vid):
            vids.append(vid)
            captions.append(_caption(name, anno["caption"]))

    vocab_vids = sorted(set(vids))
    vocab_pos = {v: i for i, v in enumerate(vocab_vids)}
    item_video_idx = np.asarray([vocab_pos[v] for v in vids], np.int32)
    print(f"num {split} data: {len(captions)}/{len(annotations)}")
    return RetrievalDataset(
        name=name,
        captions=captions,
        item_video_idx=item_video_idx,
        split=split,
        vids=vids,
        store=store,
        vocab_vids=vocab_vids,
    )


def load_iv2_scores(scores_dir: str, dataset: str, zeroshot: bool) -> Dict[str, np.ndarray]:
    """Precomputed InternVideo2 matrices {scores_dir}/{dataset}[_zeroshot]
    .npz or .pth -> {"v2t", "t2v"} float arrays."""
    stem = dataset.lower() + ("_zeroshot" if zeroshot else "")
    npz = os.path.join(scores_dir, f"{stem}.npz")
    if os.path.exists(npz):
        data = np.load(npz)
        return {"v2t": data["v2t"], "t2v": data["t2v"]}
    pth = os.path.join(scores_dir, f"{stem}.pth")
    if os.path.exists(pth):
        import torch

        data = torch.load(pth, map_location="cpu", weights_only=True)
        return {"v2t": data["v2t"].float().numpy(), "t2v": data["t2v"].float().numpy()}
    raise FileNotFoundError(f"no InternVideo2 scores for {dataset} in {scores_dir}")


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
