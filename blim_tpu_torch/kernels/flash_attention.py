"""Flash attention, forward and backward: the hand-written Hopper kernels
(csrc/flash_fwd.cu, csrc/flash_fwd_dense.cu, csrc/flash_bwd.cu,
csrc/flash_bwd_dense.cu), their wrappers, their plain PyTorch versions and
the autograd Function that joins them. Port of
blim_tpu/kernels/flash_attention.py: `_fwd_kernel` without lse (B1, the
zero-shot prefix forwards, d = 128, flash_fwd.cu), with lse (B1-lse,
`_vjp_fwd`), and in its dense non-causal mode at d = 64 without lse (B2,
every attention of the UMT ViT, flash_fwd_dense.cu) and with it (B2-lse,
the ViT under autograd), `_dq_kernel`
(B3) and `_dkv_kernel` (B4) at d = 128, both of them at d = 64 dense and
non-causal as one fused kernel (flash_bwd_dense, between its preprocess and
convert passes), and the custom VJP `_flash_attention`.

Build. At first use a wrapper compiles its source with nvcc for sm_90a into
a shared library with plain C entry points and loads it with ctypes. Each
library lands in `blim_tpu_torch/_build/<name>-<hash>/`, keyed by a hash of
its source, the headers it includes (`csrc/hopper.cuh`) and the flags, so
an edit rebuilds. `build()` compiles every source at once, one nvcc each. A
failed build raises: there is no fallback to the plain version on a CUDA
tensor.

Dispatch. A CPU tensor goes to the plain version; a CUDA tensor launches
the kernel or raises. The head dims the kernels take are those the sources
instantiate: 128 in every mode (B1, B1-lse, B3, B4); 64 only dense (no
masks) and non-causal (B2, B2-lse, flash_bwd_dense), the ViT's mode; any
other raises. The counters count kernel launches and nothing else: `launches` (B1, inference), `launches_lse` (B1-lse),
`launches_dense` (B2), `launches_dense_lse` (B2-lse), `launches_dq` (B3),
`launches_dkv` (B4), `launches_bwd_dense` (the fused d = 64 backward),
`launches_bwd_dense_prep` and `launches_bwd_dense_convert` (its two
passes). Callers reset them to 0 to check that a path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from blim_tpu_torch.kernels.attention import NEG_INF, reference_attention

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"flash_fwd": CSRC / "flash_fwd.cu", "flash_fwd_dense": CSRC / "flash_fwd_dense.cu",
           "flash_bwd": CSRC / "flash_bwd.cu", "flash_bwd_dense": CSRC / "flash_bwd_dense.cu"}
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEAD_DIM = 128        # B1, B1-lse, B3, B4 (the 7B decoder)
DENSE_HEAD_DIM = 64   # B2, B2-lse, flash_bwd_dense (the UMT ViT-L: hidden 1024 over 16 heads)
DQ_TILE_ROWS = 64     # flash_bwd_dense's q tile: one tile of its fp32 dQ accumulator
DENSE_Q_ROWS = 192    # flash_fwd_dense's q rows a CTA: three consumer warpgroups of 64
DENSE_KV_TILE = 112   # flash_fwd_dense's kv tile: 28 tiles at the ViT's S = 3136, 7 at 784

launches = 0          # B1 (no lse) launches since the caller last reset it
launches_lse = 0      # B1-lse launches
launches_dense = 0    # B2 launches
launches_dense_lse = 0  # B2-lse launches
launches_dq = 0       # B3 launches
launches_dkv = 0      # B4 launches
launches_bwd_dense = 0  # fused d = 64 backward launches
launches_bwd_dense_prep = 0     # its preprocess pass's launches
launches_bwd_dense_convert = 0  # its convert pass's launches
_libs: Dict[str, ctypes.CDLL] = {}


# counts()' keys -> the counters' names in this module
_COUNTERS = {"flash_fwd": "launches", "flash_fwd_lse": "launches_lse",
             "flash_fwd_dense": "launches_dense", "flash_fwd_dense_lse": "launches_dense_lse",
             "flash_dq": "launches_dq", "flash_dkv": "launches_dkv",
             "flash_bwd_dense": "launches_bwd_dense",
             "flash_bwd_dense_prep": "launches_bwd_dense_prep",
             "flash_bwd_dense_convert": "launches_bwd_dense_convert"}


def reset_counts() -> None:
    for name in _COUNTERS.values():
        globals()[name] = 0


def counts() -> Dict[str, int]:
    return {key: globals()[name] for key, name in _COUNTERS.items()}


def add_counts(delta: Dict[str, int]) -> None:
    """Add `delta` (keyed as counts()) to the counters: the launches of a
    replayed CUDA graph (engine/step_graphs.py), which runs no Python."""
    for key, n in delta.items():
        globals()[_COUNTERS[key]] += n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(name: str = "flash_fwd") -> Path:
    """Where the named source's library lands, keyed by the source, every
    header beside it (csrc/*.cuh, which the sources include) and the flags."""
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(SOURCES[name].parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_ROOT / f"{name}-{digest[:16]}" / f"lib{name}.so"


def build(names=tuple(SOURCES)) -> Dict[str, str]:
    """Compile each named source whose library does not exist yet, all at
    once; returns {name: compiler report (ptxas registers, shared memory,
    spills)}, "" for a library that was already built."""
    nvcc = None
    running = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        nvcc = nvcc or _nvcc()
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, so)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, so) in running.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {SOURCES[name].name}:\n{out}")
            continue
        (so.parent / "build.log").write_text(out)
        os.replace(tmp, so)
        reports[name] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Declares the C entry points of the library built from SOURCES[name]
    (a copy of it, such as an edited variant, takes the same name)."""
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    if name == "flash_fwd":
        lib.blim_flash_fwd.argtypes = (
            [ptr] * 7 + [i64] * 2 + [i32] * 5 + [i64] * 13 + [f32, i32, ptr]
        )
        lib.blim_flash_fwd.restype = i32
        lib.blim_flash_fwd_smem_bytes.argtypes = [i32]
        lib.blim_flash_fwd_smem_bytes.restype = i32
        lib.blim_cuda_error_string.argtypes = [i32]
        lib.blim_cuda_error_string.restype = ctypes.c_char_p
    elif name == "flash_fwd_dense":
        lib.blim_flash_fwd_dense.argtypes = (
            [ptr] * 5 + [i64] * 2 + [i32] * 4 + [i64] * 12 + [f32, ptr]
        )
        lib.blim_flash_fwd_dense.restype = i32
        lib.blim_flash_fwd_dense_smem_bytes.argtypes = []
        lib.blim_flash_fwd_dense_smem_bytes.restype = i32
        lib.blim_flash_fwd_dense_error_string.argtypes = [i32]
        lib.blim_flash_fwd_dense_error_string.restype = ctypes.c_char_p
    elif name == "flash_bwd":
        lib.blim_flash_dq.argtypes = [ptr] * 8 + [i32] * 5 + [i64] * 16 + [f32, i32, ptr]
        lib.blim_flash_dq.restype = i32
        lib.blim_flash_dkv.argtypes = [ptr] * 9 + [i32] * 5 + [i64] * 19 + [f32, i32, ptr]
        lib.blim_flash_dkv.restype = i32
        lib.blim_flash_bwd_smem_bytes.argtypes = [i32, i32]
        lib.blim_flash_bwd_smem_bytes.restype = i32
        lib.blim_flash_dkv_cluster_occupancy.argtypes = [i32]
        lib.blim_flash_dkv_cluster_occupancy.restype = i32
        lib.blim_flash_bwd_error_string.argtypes = [i32]
        lib.blim_flash_bwd_error_string.restype = ctypes.c_char_p
    elif name == "flash_bwd_dense":
        lib.blim_flash_bwd_dense_prep.argtypes = [ptr] * 4 + [i32] * 3 + [i64] * 6 + [ptr]
        lib.blim_flash_bwd_dense_prep.restype = i32
        lib.blim_flash_bwd_dense.argtypes = [ptr] * 9 + [i32] * 3 + [i64] * 18 + [f32, ptr]
        lib.blim_flash_bwd_dense.restype = i32
        lib.blim_flash_bwd_dense_convert.argtypes = [ptr] * 2 + [i32] * 3 + [i64] * 3 + [f32, ptr]
        lib.blim_flash_bwd_dense_convert.restype = i32
        lib.blim_flash_bwd_dense_smem_bytes.argtypes = []
        lib.blim_flash_bwd_dense_smem_bytes.restype = i32
        lib.blim_flash_bwd_dense_error_string.argtypes = [i32]
        lib.blim_flash_bwd_dense_error_string.restype = ctypes.c_char_p
    else:
        raise ValueError(f"no library named {name!r}")
    return lib


def _library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build((name,))
        _libs[name] = bind(ctypes.CDLL(str(library_path(name))), name)
    return _libs[name]


def _raise_on(rc: int, what: str, error_string) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({error_string(rc).decode()})")


def _check_operand(name: str, t: torch.Tensor, device: torch.device,
                   head_dim: int = HEAD_DIM) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.shape[-1] != head_dim:
        raise ValueError(f"{name} must be (B, S, H, {head_dim}), got {tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s last dimension must be contiguous")
    if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned with strides that are multiples of 8")


def _check_shapes(q, k, v) -> None:
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or q.shape[2] % k.shape[2]:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")


def _mask_operand(m: Optional[torch.Tensor], shape, device) -> torch.Tensor:
    if m is None:
        return torch.ones(shape, dtype=torch.int32, device=device)
    if tuple(m.shape) != tuple(shape):
        raise ValueError(f"mask must be {tuple(shape)}, got {tuple(m.shape)}")
    if m.device != device:
        raise ValueError(f"mask is on {m.device}, expected {device}")
    return m.to(torch.int32).contiguous()


def kernel_head_dim(q: torch.Tensor, key_mask, query_mask, causal: bool) -> int:
    """The head dim the kernels take in this mode: DENSE_HEAD_DIM for a
    d = 64 operand without masks and not causal (the ViT's mode), else
    HEAD_DIM. An operand of any other head dim fails the check against it."""
    dense64 = (q.shape[-1] == DENSE_HEAD_DIM and key_mask is None and query_mask is None
               and not causal)
    return DENSE_HEAD_DIM if dense64 else HEAD_DIM


def _cuda_device(q: torch.Tensor, entry: str) -> torch.device:
    if q.device.type != "cuda":
        raise ValueError(f"{entry} runs on CUDA or CPU tensors, got {q.device}")
    return q.device


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, and the yardstick the kernels are held to)
# ---------------------------------------------------------------------------

def _visible(s: int, key_mask: Optional[torch.Tensor], causal: bool,
             device) -> Optional[torch.Tensor]:
    """(B or 1, 1, 1, S, S) bool: query i sees key j."""
    idx = torch.arange(s, device=device)
    vis = (idx[:, None] >= idx[None, :])[None, None, None] if causal else None
    if key_mask is not None:
        km = key_mask.bool()[:, None, None, None, :]
        vis = km if vis is None else vis & km
    return vis


def reference_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None, query_mask: Optional[torch.Tensor] = None,
    causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of B1-lse: reference_attention's output and the fp32
    logsumexp rows (B, Hq, S) of the masked scaled scores, the TPU kernel's
    `m + log(l)`. A row whose keys are all masked gets -1e30 + log(S) here;
    the kernels' value depends on how many keys their tiling visits, and
    neither reaches a gradient."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    out = reference_attention(q, k, v, key_mask, query_mask, causal, scale)
    qg = (q.float() * scale).reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    vis = _visible(s, key_mask, causal, q.device)
    if vis is not None:
        scores = scores.masked_fill(~vis, NEG_INF)
    return out, torch.logsumexp(scores, dim=-1).reshape(b, hq, s)


def _mask_grad(dout: torch.Tensor, query_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if query_mask is None:
        return dout
    return dout * query_mask[:, :, None, None].to(dout.dtype)


def reference_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_mask: Optional[torch.Tensor], query_mask: Optional[torch.Tensor],
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of B3 + B4: `_flash_backward`'s math step by step in
    fp32 (not autograd). dO is multiplied by the query mask before delta =
    rowsum(dO * O) and before anything else reads it, so fully masked query
    rows contribute nothing. Returns (dq, dk, dv) in q's, k's and v's dtype."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    grp = hq // hkv
    if scale is None:
        scale = d ** -0.5
    g = _mask_grad(dout, query_mask).float()
    delta = (g * out.float()).sum(dim=-1)                                   # (B, S, Hq)
    qs = (q.float() * scale).reshape(b, s, hkv, grp, d)
    kf, vf = k.float(), v.float()
    gg = g.reshape(b, s, hkv, grp, d)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qs, kf)
    vis = _visible(s, key_mask, causal, q.device)
    if vis is not None:
        sc = sc.masked_fill(~vis, NEG_INF)
    p = torch.exp(sc - lse.reshape(b, hkv, grp, s)[..., None])
    dp = torch.einsum("bqhgd,bkhd->bhgqk", gg, vf)
    ds = p * (dp - delta.reshape(b, s, hkv, grp).permute(0, 2, 3, 1)[..., None])
    if vis is not None:
        ds = ds.masked_fill(~vis, 0.0)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(b, s, hq, d) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qs)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, gg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def dq_accumulator_order(device=None) -> torch.Tensor:
    """Where flash_bwd_dense keeps each element of a (64, 64) dQ tile among
    the tile's 4096 floats in its fp32 accumulator: entry (r, c) is the
    offset of q row r, column c. Float4 (j, t) holds what consumer thread t
    holds after its dQ product: columns 8j + 2(t % 4) + {0, 1} of rows
    16(t // 32) + (t % 32) // 4 and that + 8, so its stores are
    conflict-free (csrc/flash_bwd_dense.cu, dq_acc_offset)."""
    r = torch.arange(DQ_TILE_ROWS, device=device)[:, None]
    c = torch.arange(DENSE_HEAD_DIM, device=device)[None, :]
    t = 32 * (r // 16) + 4 * (r % 8) + (c % 8) // 2
    return ((c // 8) * 128 + t) * 4 + 2 * ((r % 16) // 8) + c % 2


def reference_bwd_dense_prep(out: torch.Tensor, dout: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of flash_bwd_dense's preprocess: delta =
    rowsum(dO * O) in fp32, (B, H, S), and the fp32 dQ accumulator (B, H,
    ceil(S / 64), 4096) filled with zeros."""
    b, s, h, d = out.shape
    delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
    acc = torch.zeros((b, h, -(-s // DQ_TILE_ROWS), DQ_TILE_ROWS * d), dtype=torch.float32,
                      device=out.device)
    return delta, acc


def reference_bwd_dense_convert(acc: torch.Tensor, seq_len: int, scale: float) -> torch.Tensor:
    """The plain version of flash_bwd_dense's convert: dq (B, S, H, 64) in
    bf16, scale times the accumulator's rows < S, read through
    dq_accumulator_order."""
    b, h, n_q, _ = acc.shape
    tiles = acc[..., dq_accumulator_order(acc.device)]              # (B, H, n_q, 64, 64)
    rows = tiles.reshape(b, h, n_q * DQ_TILE_ROWS, DENSE_HEAD_DIM)[:, :, :seq_len]
    return (rows * scale).to(torch.bfloat16).transpose(1, 2)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _launch_fwd(q, k, v, key_mask, query_mask, causal, scale, with_lse: bool):
    """One launch of flash_fwd.cu (d = 128); the caller counts it."""
    dev = _cuda_device(q, "flash_attention")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, dev)
    _check_shapes(q, k, v)
    b, s, hq, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev) if with_lse else None
    if q.numel() == 0:
        return out, lse
    dense = key_mask is None and query_mask is None
    km = qm = None
    if not dense:
        km = _mask_operand(key_mask, (b, s), dev)
        qm = _mask_operand(query_mask, (b, s), dev)
    lib = _library("flash_fwd")
    rc = lib.blim_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if dense else km.data_ptr(), None if dense else qm.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), hq * s, s,
        b, s, hq, k.shape[2], HEAD_DIM,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        0 if dense else km.stride(0),
        float(scale), int(bool(causal)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "flash_fwd", lib.blim_cuda_error_string)
    return out, lse


def _dense_forward_call(q, k, v, with_lse: bool, scale: float):
    """flash_fwd_dense.cu's C entry point on operands that it reads in place
    (q (B, S, Hq, 64), k, v (B, S, Hkv, 64) bf16, checked by the caller):
    (out, lse or None, call), the outputs contiguous. `call` launches one
    kernel on the current stream and returns its CUDA error code; nothing
    is checked or counted."""
    lib = _library("flash_fwd_dense")
    b, s, hq, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) if with_lse else None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), hq * s, s, b, s, hq, k.shape[2],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], float(scale))

    def call() -> int:
        return lib.blim_flash_fwd_dense(*args, torch.cuda.current_stream(q.device).cuda_stream)

    call.operands = (q, k, v, out, lse)   # the pointers in args stay valid while call lives
    return out, lse, call


def _launch_fwd_dense(q, k, v, scale, with_lse: bool):
    """One launch of flash_fwd_dense.cu (d = 64, dense, non-causal); the
    caller counts it."""
    dev = _cuda_device(q, "flash_attention_dense")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, dev, DENSE_HEAD_DIM)
    _check_shapes(q, k, v)
    out, lse, call = _dense_forward_call(q, k, v, with_lse, scale)
    if q.numel() == 0:
        return out, lse
    _raise_on(call(), "flash_fwd_dense",
              _library("flash_fwd_dense").blim_flash_fwd_dense_error_string)
    return out, lse


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
    """B1, inference: q (B,S,Hq,128); k,v (B,S,Hkv,128) bf16; masks (B,S) ->
    (B,S,Hq,128). No gradient flows through it.

    Both masks None selects the dense variant, which loads no mask; one mask
    alone is paired with an all-ones other, as in the JAX wrapper."""
    global launches
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return reference_attention(q, k, v, key_mask, query_mask, causal, scale)
    out = _launch_fwd(q, k, v, key_mask, query_mask, causal, scale, with_lse=False)[0]
    launches += 1
    return out


def flash_attention_lse(q, k, v, *, key_mask=None, query_mask=None, causal=True,
                        scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1-lse: flash_attention's output and the fp32 logsumexp rows (B, Hq, S),
    written for rows < S. At head dim 64 without masks and not causal (the
    ViT's mode, operands possibly strided views) it is B2-lse, launched from
    flash_fwd_dense.cu."""
    global launches_lse, launches_dense_lse
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return reference_attention_lse(q, k, v, key_mask, query_mask, causal, scale)
    if kernel_head_dim(q, key_mask, query_mask, causal) == DENSE_HEAD_DIM:
        out = _launch_fwd_dense(q, k, v, scale, with_lse=True)
        launches_dense_lse += 1
        return out
    out = _launch_fwd(q, k, v, key_mask, query_mask, causal, scale, with_lse=True)
    launches_lse += 1
    return out


def flash_attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """B2, inference: full (non-causal) attention without masks at head dim
    64, the UMT ViT's. q (B,S,Hq,64); k,v (B,S,Hkv,64) bf16 -> (B,S,Hq,64).
    The operands may be strided views (the ViT passes slices of its packed
    qkv projection, read in place) and launch flash_fwd_dense.cu. A CPU
    tensor takes the plain version, reference_attention(causal=False) with
    no masks."""
    global launches_dense
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return reference_attention(q, k, v, None, None, False, scale)
    out = _launch_fwd_dense(q, k, v, scale, with_lse=False)[0]
    launches_dense += 1
    return out


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_mask: Optional[torch.Tensor], query_mask: Optional[torch.Tensor],
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B3 + B4 (`_flash_backward`): dO times the query mask and delta =
    rowsum(dO * O) in fp32 are two torch ops, as they were XLA outside Pallas;
    then B3 writes dq and B4 writes dk and dv. At head dim 64 without masks
    and not causal (the ViT's mode, one q head a K/V head) the fused kernel
    writes all three between its preprocess and convert passes
    (_flash_attention_backward_dense). q, k and v are read in place at every
    head dim (the TMA maps take their strides, so the ViT's strided views of
    its packed qkv need no copy). Same signature and result as
    reference_attention_backward, which a CPU tensor takes."""
    global launches_dq, launches_dkv
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return reference_attention_backward(q, k, v, key_mask, query_mask, out, lse, dout,
                                            causal, scale)
    dev = _cuda_device(q, "flash_attention_backward")
    if kernel_head_dim(q, key_mask, query_mask, causal) == DENSE_HEAD_DIM:
        return _flash_attention_backward_dense(q, k, v, out, lse, dout, scale)
    g = _mask_grad(dout, query_mask).to(q.dtype).contiguous()
    delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()  # (B, Hq, S)
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", g)):
        _check_operand(name, t, dev)
    _check_shapes(q, k, v)
    b, s, hq, _ = q.shape
    _check_lse(lse, (b, hq, s), dev)
    if q.numel() == 0:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    km = None if key_mask is None else _mask_operand(key_mask, (b, s), dev)
    dq, dk, dv, call_dq, call_dkv = _backward_calls(q, k, v, g, lse.contiguous(), delta, km,
                                                    scale, causal)
    error_string = _library("flash_bwd").blim_flash_bwd_error_string
    _raise_on(call_dq(), "flash_dq", error_string)
    launches_dq += 1
    _raise_on(call_dkv(), "flash_dkv", error_string)
    launches_dkv += 1
    return dq, dk, dv


def _check_lse(lse: torch.Tensor, shape, device: torch.device) -> None:
    if lse.shape != shape or lse.dtype != torch.float32 or lse.device != device:
        raise ValueError(f"lse must be fp32 {shape} on {device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")


def _in_place(t: torch.Tensor) -> torch.Tensor:
    """t itself where a TMA map and 16-byte loads read it in place
    (contiguous last dim, strides multiples of 8, 16-byte aligned), else a
    contiguous copy."""
    if t.stride(-1) == 1 and not any(st % 8 for st in t.stride()[:-1]) and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def _flash_attention_backward_dense(q, k, v, out, lse, dout, scale):
    """The d = 64 dense non-causal backward: flash_bwd_dense.cu's three
    launches in stream order, the preprocess (delta, the accumulator
    zeroed), the fused kernel (dk, dv, and every kv tile's dQ added into the
    accumulator) and the convert (dq). One q head a K/V head (the ViT's);
    dO and O are read in place where their strides allow."""
    global launches_bwd_dense, launches_bwd_dense_prep, launches_bwd_dense_convert
    dev = q.device
    g, o = _in_place(dout.to(q.dtype)), _in_place(out)
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", g), ("out", o)):
        _check_operand(name, t, dev, DENSE_HEAD_DIM)
    if not q.shape == k.shape == v.shape == g.shape == o.shape:
        raise ValueError(f"the d = {DENSE_HEAD_DIM} backward takes one q head a K/V head and "
                         f"equal shapes: q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} dout {tuple(g.shape)} out {tuple(o.shape)}")
    b, s, h, _ = q.shape
    _check_lse(lse, (b, h, s), dev)
    if q.numel() == 0:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq, dk, dv, _, _, call_prep, call_bwd, call_convert = _dense_backward_calls(
        q, k, v, g, o, lse.contiguous(), scale)
    error_string = _library("flash_bwd_dense").blim_flash_bwd_dense_error_string
    _raise_on(call_prep(), "flash_bwd_dense_prep", error_string)
    launches_bwd_dense_prep += 1
    _raise_on(call_bwd(), "flash_bwd_dense", error_string)
    launches_bwd_dense += 1
    _raise_on(call_convert(), "flash_bwd_dense_convert", error_string)
    launches_bwd_dense_convert += 1
    return dq, dk, dv


def _dense_backward_calls(q, k, v, g, out, lse, scale):
    """flash_bwd_dense.cu's three C entry points on prepared operands (q, k,
    v, g = dO and out (B, S, H, 64) bf16 that the kernels read in place; lse
    contiguous fp32 (B, H, S)): (dq, dk, dv, delta, acc, call_prep,
    call_bwd, call_convert), the outputs contiguous. Each call launches one
    kernel on the current stream and returns its CUDA error code; nothing
    is checked or counted."""
    lib = _library("flash_bwd_dense")
    b, s, h, d = q.shape
    dev = q.device
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=dev) for _ in range(3))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    acc = torch.empty((b, h, -(-s // DQ_TILE_ROWS), DQ_TILE_ROWS * d), dtype=torch.float32,
                      device=dev)

    def stream() -> int:
        return torch.cuda.current_stream(dev).cuda_stream

    def call_prep() -> int:
        return lib.blim_flash_bwd_dense_prep(out.data_ptr(), g.data_ptr(), delta.data_ptr(),
                                             acc.data_ptr(), b, s, h, *out.stride()[:3],
                                             *g.stride()[:3], stream())

    def call_bwd() -> int:
        return lib.blim_flash_bwd_dense(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
            *dk.stride()[:3], *dv.stride()[:3], float(scale), stream())

    def call_convert() -> int:
        return lib.blim_flash_bwd_dense_convert(acc.data_ptr(), dq.data_ptr(), b, s, h,
                                                *dq.stride()[:3], float(scale), stream())

    return dq, dk, dv, delta, acc, call_prep, call_bwd, call_convert


def _backward_calls(q, k, v, g, lse, delta, key_mask, scale, causal):
    """flash_bwd.cu's two C entry points on prepared operands (q, k, v, g =
    dO times the query mask, each with a contiguous last dim; lse, delta
    contiguous fp32 (B, Hq, S); an int32 key mask with unit stride along S,
    or None): (dq, dk, dv, call_dq, call_dkv), the outputs contiguous. Each
    call launches one kernel on the current stream into the outputs and
    returns its CUDA error code; nothing is checked or counted."""
    lib = _library("flash_bwd")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), None if key_mask is None else key_mask.data_ptr())
    shape = (b, s, hq, hkv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *g.stride()[:3])
    tail = (0 if key_mask is None else key_mask.stride(0), float(scale), int(bool(causal)))

    def call_dq() -> int:
        return lib.blim_flash_dq(*inputs, dq.data_ptr(), *shape, *dq.stride()[:3], *tail,
                                 torch.cuda.current_stream(q.device).cuda_stream)

    def call_dkv() -> int:
        return lib.blim_flash_dkv(*inputs, dk.data_ptr(), dv.data_ptr(), *shape,
                                  *dk.stride()[:3], *dv.stride()[:3], *tail,
                                  torch.cuda.current_stream(q.device).cuda_stream)

    # the pointers in `inputs` stay valid while a call lives
    call_dq.operands = call_dkv.operands = (q, k, v, g, lse, delta, key_mask)
    return dq, dk, dv, call_dq, call_dkv


class FlashAttentionFunction(torch.autograd.Function):
    """The counterpart of the JAX custom VJP `_flash_attention` (`_vjp_fwd` /
    `_vjp_bwd`): the forward runs B1-lse and saves q, k, v, the masks, O and
    lse; the backward runs B3 and B4 and returns gradients for q, k, v only.
    At head dim 64, dense and not causal (the ViT's mode) the same ends run
    B2-lse and the fused flash_bwd_dense with its two passes. CPU tensors
    take the plain versions at both ends."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, query_mask, causal, scale):
        out, lse = flash_attention_lse(q, k, v, key_mask=key_mask, query_mask=query_mask,
                                       causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, key_mask, query_mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, query_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, key_mask, query_mask, out, lse, dout,
                                              ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None
