"""Flash-attention forward: the hand-written Hopper kernel (csrc/flash_fwd.cu)
and its wrapper. Port of blim_tpu/kernels/flash_attention.py's forward
(`_fwd_kernel` via `_flash_forward` / `flash_attention`), inference mode.

Build. At first use the wrapper compiles csrc/flash_fwd.cu with nvcc for
sm_90a into a shared library with a plain C entry point and loads it with
ctypes. The library lands in `blim_tpu_torch/_build/<name>-<hash>/`, keyed
by a hash of the source and the flags, so an edit rebuilds. A failed build
raises: there is no fallback to the plain version on a CUDA tensor.

Dispatch. A CPU tensor goes to the plain version (attention.reference_attention);
a CUDA tensor launches the kernel or raises. `launches` counts kernel
launches and nothing else; callers reset it to 0 to check that a path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from blim_tpu_torch.kernels.attention import reference_attention

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEAD_DIM = 128

launches = 0          # kernel launches since the caller last reset it
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernel")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_ROOT / f"flash_fwd-{digest[:16]}" / "libflash_fwd.so"


def build() -> str:
    """Compile the kernel unless this source's library exists; returns the
    compiler's report (ptxas registers, shared memory, spills), "" when the
    library was already built."""
    so = library_path()
    if so.exists():
        return ""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    report = proc.stdout + proc.stderr
    (so.parent / "build.log").write_text(report)
    os.replace(tmp, so)
    return report


def _library():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.blim_flash_fwd.argtypes = (
            [ptr] * 6 + [i32] * 4 + [i64] * 13 + [ctypes.c_float, i32, ptr]
        )
        lib.blim_flash_fwd.restype = i32
        lib.blim_cuda_error_string.argtypes = [i32]
        lib.blim_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_operand(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name} must be (B, S, H, {HEAD_DIM}), got {tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s last dimension must be contiguous")
    if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned with strides that are multiples of 8")


def _mask_operand(m: Optional[torch.Tensor], shape, device) -> torch.Tensor:
    if m is None:
        return torch.ones(shape, dtype=torch.int32, device=device)
    if tuple(m.shape) != tuple(shape):
        raise ValueError(f"mask must be {tuple(shape)}, got {tuple(m.shape)}")
    if m.device != device:
        raise ValueError(f"mask is on {m.device}, expected {device}")
    return m.to(torch.int32).contiguous()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_mask: Optional[torch.Tensor] = None,
    query_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q (B,S,Hq,128); k,v (B,S,Hkv,128) bf16; masks (B,S) -> (B,S,Hq,128).

    Both masks None selects the dense variant, which loads no mask; one mask
    alone is paired with an all-ones other, as in the JAX wrapper."""
    global launches
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return reference_attention(q, k, v, key_mask, query_mask, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device)
    b, s, hq, _ = q.shape
    hkv = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or hq % hkv:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return out
    dense = key_mask is None and query_mask is None
    km = qm = None
    if not dense:
        km = _mask_operand(key_mask, (b, s), q.device)
        qm = _mask_operand(query_mask, (b, s), q.device)
    lib = _library()
    rc = lib.blim_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if dense else km.data_ptr(), None if dense else qm.data_ptr(), out.data_ptr(),
        b, s, hq, hkv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        0 if dense else km.stride(0),
        float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {rc} "
                           f"({lib.blim_cuda_error_string(rc).decode()})")
    launches += 1
    return out
