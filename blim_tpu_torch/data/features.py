"""Video feature cache IO (copy of blim_tpu/data/features.py).

Per-video ToMe features, shape (4, 64, 1024), are cached as fp16 `.npy`
files (`{root}/{vid}.npy`); reference-produced `.pth` caches are read too,
and a missing video reads as zeros, as the reference's dataset does. A
packed single-file format (`features.pack` + `features.idx.json`) makes a
10k-video dataset one sequential mmap read instead of 10k file opens.
`load_many` gathers from the pack through the native reader
(data/native_pack.py: an mmap and fp16 -> fp32 conversion on host threads)
and, where it cannot be built, through a numpy memmap, as the JAX store
does. `reader` says which: "native", "memmap", or None without a pack.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from blim_tpu_torch.data.native_pack import NativePack


class FeatureStore:
    """Per-video cached features with zero-fallback."""

    def __init__(
        self,
        root: str,
        shape: Tuple[int, int, int] = (4, 64, 1024),
        dtype=np.float32,
    ):
        self.root = root
        self.shape = shape
        self.dtype = dtype
        self._pack: Optional[np.memmap] = None
        self._pack_index: Dict[str, int] = {}
        self._native = None
        self.reader: Optional[str] = None
        pack_path = os.path.join(root, "features.pack")
        idx_path = os.path.join(root, "features.idx.json")
        if os.path.exists(pack_path) and os.path.exists(idx_path):
            with open(idx_path) as f:
                meta = json.load(f)
            self._pack_index = meta["index"]
            self.shape = tuple(meta["shape"])
            self._pack = np.memmap(
                pack_path, dtype=np.dtype(meta["dtype"]), mode="r",
                shape=(len(self._pack_index), *self.shape),
            )
            try:
                self._native = NativePack(
                    pack_path, len(self._pack_index), self.shape, meta["dtype"]
                )
            except RuntimeError:
                pass  # the reader cannot be built or cannot open the pack: the memmap
            self.reader = "memmap" if self._native is None else "native"

    def available(self, vid: str) -> bool:
        if vid in self._pack_index:
            return True
        return any(
            os.path.exists(os.path.join(self.root, f"{vid}{ext}")) for ext in (".npy", ".pth")
        )

    def load(self, vid: str) -> np.ndarray:
        """(clips, tokens, mm) features; zeros if missing (reference fallback)."""
        if vid in self._pack_index:
            return np.asarray(self._pack[self._pack_index[vid]], self.dtype)
        npy = os.path.join(self.root, f"{vid}.npy")
        if os.path.exists(npy):
            return np.load(npy).astype(self.dtype)
        pth = os.path.join(self.root, f"{vid}.pth")
        if os.path.exists(pth):
            import torch

            return torch.load(pth, map_location="cpu", weights_only=True).float().numpy().astype(self.dtype)
        return np.zeros(self.shape, self.dtype)

    def load_many(self, vids: Sequence[str]) -> np.ndarray:
        if self._pack is not None and all(v in self._pack_index for v in vids):
            idx = np.asarray([self._pack_index[v] for v in vids], np.int64)
            if self._native is not None:
                return self._native.gather(idx)
            return np.asarray(self._pack[idx], self.dtype)
        return np.stack([self.load(v) for v in vids], axis=0)

    def save(self, vid: str, features: np.ndarray) -> None:
        np.save(os.path.join(self.root, f"{vid}.npy"), features.astype(np.float16))

    @staticmethod
    def write_pack(root: str, vids: Sequence[str], features: np.ndarray, dtype="float16") -> None:
        """Pack (V, ...) features into features.pack + features.idx.json."""
        arr = np.ascontiguousarray(features.astype(np.dtype(dtype)))
        with open(os.path.join(root, "features.pack"), "wb") as f:
            f.write(arr.tobytes())
        with open(os.path.join(root, "features.idx.json"), "w") as f:
            json.dump(
                {
                    "index": {v: i for i, v in enumerate(vids)},
                    "shape": list(arr.shape[1:]),
                    "dtype": dtype,
                },
                f,
            )
