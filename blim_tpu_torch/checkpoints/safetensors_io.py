"""Reader and writer of the safetensors format, without the `safetensors`
package.

A file is an 8-byte little-endian header length n, n bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}, optional
"__metadata__": {str: str}}), then the tensors' bytes back to back, each
[begin, end) relative to the end of the header. The reader maps the file
(`mmap`, copy-on-write, so the buffer is writable and nothing is copied
until written) and hands out tensors that view the map, so a tensor's bytes
are read from disk only when it is used, typically when it is copied to the
device. The map lives as long as any tensor viewing it.

A sharded checkpoint (the published 7B is one) is several files plus
`model.safetensors.index.json`, whose `weight_map` names each tensor's file;
`save_sharded` writes that layout and `checkpoint_files` reads it.
"""

from __future__ import annotations

import glob
import json
import math
import mmap
import os
import struct
from typing import Dict, List, Mapping, Optional, Tuple

import torch

DTYPES: Dict[str, torch.dtype] = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "U8": torch.uint8, "BOOL": torch.bool,
}
CODES: Dict[torch.dtype, str] = {v: k for k, v in DTYPES.items()}
INDEX_FILE = "model.safetensors.index.json"


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def read_header(path: str) -> Tuple[Dict[str, dict], Dict[str, str], int]:
    """(tensor entries, metadata, byte offset of the data) of one file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    metadata = header.pop("__metadata__", None) or {}
    return header, metadata, 8 + n


class SafetensorsFile:
    """One memory-mapped .safetensors file: `keys()`, `dtype_shape(name)`,
    and `get(name)`, a CPU tensor viewing the map (no copy)."""

    def __init__(self, path: str):
        self.path = path
        self.entries, self.metadata, self.data_start = read_header(path)
        with open(path, "rb") as f:
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)

    def keys(self) -> List[str]:
        return list(self.entries)

    def dtype_shape(self, name: str) -> Tuple[torch.dtype, Tuple[int, ...]]:
        e = self.entries[name]
        if e["dtype"] not in DTYPES:
            raise ValueError(f"{self.path}: tensor {name} has dtype {e['dtype']}, "
                             f"not one of {sorted(DTYPES)}")
        return DTYPES[e["dtype"]], tuple(e["shape"])

    def get(self, name: str) -> torch.Tensor:
        dtype, shape = self.dtype_shape(name)
        begin, end = self.entries[name]["data_offsets"]
        n = math.prod(shape)
        size = _itemsize(dtype)
        if end - begin != n * size or self.data_start + end > len(self._map):
            raise ValueError(f"{self.path}: tensor {name} has offsets [{begin}, {end}) for "
                             f"{n} elements of {size} bytes")
        if n == 0:
            return torch.empty(shape, dtype=dtype)
        offset = self.data_start + begin
        if offset % size:      # a misaligned tensor (not written by save_file) is copied
            buf = bytearray(self._map[offset: offset + n * size])
            return torch.frombuffer(buf, dtype=dtype).view(shape)
        return torch.frombuffer(self._map, dtype=dtype, count=n, offset=offset).view(shape)


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one file, as views of its map."""
    f = SafetensorsFile(path)
    return {k: f.get(k) for k in f.keys()}


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write `tensors` (on any device, any strides) to one file; returns the
    bytes of tensor data written. The widest dtypes come first, so every
    tensor starts at a multiple of its element size; one tensor at a time
    is brought to the host."""
    order = sorted(tensors, key=lambda k: (-_itemsize(tensors[k].dtype), k))
    header: Dict[str, dict] = {}
    offset = 0
    for k in order:
        t = tensors[k]
        if t.dtype not in CODES:
            raise ValueError(f"tensor {k} has dtype {t.dtype}, not one of {sorted(DTYPES)}")
        nbytes = t.numel() * t.element_size()
        header[k] = {"dtype": CODES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = dict(metadata)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in order:
            t = tensors[k].detach()
            if t.numel():
                f.write(t.contiguous().cpu().reshape(-1).view(torch.uint8).numpy().data)
    return offset


def shard_name(i: int, n: int) -> str:
    return f"model-{i + 1:05d}-of-{n:05d}.safetensors"


def save_sharded(tensors: Mapping[str, torch.Tensor], model_path: str,
                 max_shard_bytes: int) -> Dict[str, str]:
    """Write `tensors` in their given order into shards of at most
    `max_shard_bytes` (a larger tensor gets a shard of its own) plus
    model.safetensors.index.json; returns the weight map."""
    shards: List[List[str]] = [[]]
    load = 0
    for k, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        if shards[-1] and load + nbytes > max_shard_bytes:
            shards.append([])
            load = 0
        shards[-1].append(k)
        load += nbytes
    weight_map: Dict[str, str] = {}
    total = 0
    for i, names in enumerate(shards):
        name = shard_name(i, len(shards))
        total += save_file({k: tensors[k] for k in names}, os.path.join(model_path, name))
        weight_map.update(dict.fromkeys(names, name))
    with open(os.path.join(model_path, INDEX_FILE), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return weight_map


def checkpoint_files(model_path: str) -> Dict[str, List[str]]:
    """{file path: [tensor names]} of a checkpoint directory's safetensors:
    from the index's weight_map when there is one, else from the headers of
    every *.safetensors file. Empty when the directory has none."""
    index = os.path.join(model_path, INDEX_FILE)
    out: Dict[str, List[str]] = {}
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        for name, file in weight_map.items():
            out.setdefault(os.path.join(model_path, file), []).append(name)
        return out
    for path in sorted(glob.glob(os.path.join(model_path, "*.safetensors"))):
        out[path] = list(read_header(path)[0])
    return out
