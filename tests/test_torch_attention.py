"""The port's attention against the JAX package's, on the CPU in fp32.

A CPU tensor takes the plain PyTorch version; the JAX side runs its Pallas
flash kernel in interpret mode (as tests/test_flash_attention_kernel.py
does) or its XLA reference. The CUDA kernel itself cannot run here; it is
held to the plain version on the card by chip_smoke.py. Tolerance: fp32
sums in another order, atol 2e-5 / rtol 1e-4.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from blim_tpu.kernels import flash_attention as jfa
from blim_tpu.kernels.attention import _xla_attention

from blim_tpu_torch.kernels import flash_attention as tfa
from blim_tpu_torch.kernels.attention import multi_head_attention, reference_attention

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL, RTOL = 2e-5, 1e-4


def _inputs(rng, b, s, hq, hkv, d):
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32) * 0.3
    return q, k, v


def _holes(rng, b, s):
    """CPN-like holes plus right padding, on keys and queries alike (the
    production contract: key_mask == query_mask)."""
    m = (rng.random((b, s)) > 0.2).astype(np.int32)
    m[:, -7:] = 0
    return m


@pytest.mark.parametrize("case", ["holes", "dense", "unaligned"])
@pytest.mark.parametrize("entry", ["flash_attention", "multi_head_attention"])
def test_matches_jax_flash_kernel_interpret(rng, case, entry):
    # (1, 256, 16, 4, 128) as in the JAX kernel tests; the unaligned S=200
    # case uses the main path's 28/4 heads so that S*Hq >= 4096 and the JAX
    # wrapper runs its kernel (padded to the block) instead of XLA
    b, s, hq, hkv, d = (1, 200, 28, 4, 128) if case == "unaligned" else (1, 256, 16, 4, 128)
    q, k, v = _inputs(rng, b, s, hq, hkv, d)
    m = None if case == "dense" else _holes(rng, b, s)
    jm = None if m is None else jnp.asarray(m)
    ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         key_mask=jm, query_mask=jm, causal=True,
                                         interpret=True))
    tm = None if m is None else torch.from_numpy(m)
    fn = tfa.flash_attention if entry == "flash_attention" else multi_head_attention
    tfa.launches = 0
    out = fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
             key_mask=tm, query_mask=tm, causal=True)
    assert tfa.launches == 0
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    if m is not None:
        assert not out.numpy()[m == 0].any()  # masked queries emit zeros


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("window", [None, 5])
def test_matches_jax_xla_reference_tiny_heads(rng, causal, masked, window):
    b, s, hq, hkv, d = 2, 24, 4, 2, 16
    q, k, v = _inputs(rng, b, s, hq, hkv, d)
    m = _holes(rng, b, s) if masked else None
    jm = None if m is None else jnp.asarray(m)
    ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, jm,
                                    causal, d ** -0.5,
                                    None if window is None else jnp.int32(window)))
    tm = None if m is None else torch.from_numpy(m)
    out = reference_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              tm, tm, causal, d ** -0.5, window)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    via_dispatch = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), key_mask=tm, query_mask=tm,
                                        causal=causal, window=window)
    torch.testing.assert_close(via_dispatch, out, rtol=0, atol=0)


def test_fully_masked_rows_are_finite_then_zeroed(rng):
    """-1e30 is finite: a query whose keys are all masked gets finite garbage
    before the query mask zeroes it, never NaN."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, 1, 8, 2, 1, 16))
    km = torch.zeros((1, 8), dtype=torch.int32)
    out = reference_attention(q, k, v, km, None, True, 0.25)
    assert torch.isfinite(out).all()
    assert not reference_attention(q, k, v, km, km, True, 0.25).any()


def test_cpu_tensors_never_launch_the_kernel(rng):
    tfa.launches = 0
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, 2, 12, 4, 2, 128))
    m = torch.ones((2, 12), dtype=torch.int32)
    multi_head_attention(q, k, v, key_mask=m, query_mask=m)
    tfa.flash_attention(q, k, v)
    multi_head_attention(q, k, v, window=3)
    assert tfa.launches == 0


def test_window_uses_the_plain_path_on_cpu(rng):
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, 1, 16, 4, 2, 16))
    got = multi_head_attention(q, k, v, causal=True, window=3)
    want = reference_attention(q, k, v, None, None, True, 16 ** -0.5, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.allclose(got, multi_head_attention(q, k, v, causal=True))


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    """Off the CPU the dispatch goes to the kernel or raises: the wrapper
    refuses devices it has no kernel for. A window is not such a fallback:
    it is the plain windowed attention on every device (the JAX wrapper runs
    it as XLA whenever a window is set), so it runs there too, launching
    nothing."""
    q = torch.empty((1, 8, 4, 128), device="meta")
    k = torch.empty((1, 8, 2, 128), device="meta")
    before = tfa.counts()
    out = multi_head_attention(q, k, k, window=4)
    assert out.device.type == "meta" and out.shape == q.shape
    assert tfa.counts() == before
    with pytest.raises(ValueError):
        multi_head_attention(q, k, k)


def test_failed_build_raises(monkeypatch, tmp_path):
    import shutil

    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(tfa, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfa.build()
    assert tfa.library_path().parent.parent == tmp_path
    assert tfa.library_path().name == "libflash_fwd.so"
