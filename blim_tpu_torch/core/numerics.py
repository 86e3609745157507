"""Products with fp32 accumulation and fp32 output.

The JAX package computes scores and logits as bf16 x bf16 products with
`preferred_element_type=float32`. PyTorch's bf16 matmul rounds its output to
bf16, so the port casts to fp32 instead. On CUDA, bf16 operands then run as
TF32: bf16's 8-bit significand fits in TF32's 11, so every product is exact
and the result is the bf16 product with fp32 accumulation, on tensor cores.
fp32 operands never take the TF32 path.

Where the JAX package casts the operands themselves to fp32 before the
product (the TVG flat-query attention), `einsum_fp32` keeps TF32 off for the
call, so fp32 operands are multiplied in fp32 whatever the process's
precision setting.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _tf32(enabled: bool):
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        matmul.allow_tf32 = prev


def einsum_f32(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    exact_in_tf32 = a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16
    if not exact_in_tf32:
        return torch.einsum(equation, a.float(), b.float())
    with _tf32(True):
        return torch.einsum(equation, a.float(), b.float())


def einsum_fp32(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 operands, fp32 products: TF32 off for the call."""
    with _tf32(False):
        return torch.einsum(equation, a.float(), b.float())


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N) -> fp32 (..., N)."""
    return einsum_f32("...k,kn->...n", a, b)
