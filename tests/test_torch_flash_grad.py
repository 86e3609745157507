"""The port's differentiable flash attention against the JAX package's, on
the CPU in fp32.

The plain versions of B1-lse (`reference_attention_lse`) and of B3 + B4
(`reference_attention_backward`), and the autograd Function on CPU tensors,
are held to the JAX Pallas forward-with-lse and to `jax.vjp` of its
`flash_attention`, both in interpret mode, as
tests/test_flash_attention_kernel.py runs them. Shapes: B = 1, Hq 28,
Hkv 4, d 128 (scale 128^-1/2, so a missing or doubled scale shows), S 256
or 200, so that the JAX wrapper runs its kernels rather than XLA. Masks:
CPN-like holes with right pads, left pads (the TVG layout), and dense.
The CUDA kernels cannot run here; chip_smoke.py holds them to these plain
versions on the card.

Tolerances: fp32 sums in another order. Outputs atol 1e-5 / rtol 1e-4; lse
atol 1e-4 on rows with query mask 1 only (a fully masked row's lse depends
on how many keys the tiling visited and reaches no gradient); gradients
1e-4 x max|g| of each tensor.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blim_tpu.kernels import flash_attention as jfa

from blim_tpu_torch.kernels import flash_attention as tfa
from blim_tpu_torch.kernels.attention import multi_head_attention, reference_attention

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OUT_ATOL, OUT_RTOL = 1e-5, 1e-4
LSE_ATOL = 1e-4
GRAD_REL = 1e-4
HQ, HKV, D = 28, 4, 128
CASES = {"holes": 256, "left_pads": 256, "dense": 256, "holes_unaligned": 200}  # name -> S


def _case(name):
    s = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    q = rng.standard_normal((1, s, HQ, D)).astype(np.float32) * 0.3
    k = rng.standard_normal((1, s, HKV, D)).astype(np.float32) * 0.3
    v = rng.standard_normal((1, s, HKV, D)).astype(np.float32) * 0.3
    dout = rng.standard_normal((1, s, HQ, D)).astype(np.float32)
    if name == "dense":
        m = None
    elif name == "left_pads":
        m = np.ones((1, s), np.int32)
        m[:, :37] = 0
    else:
        m = (rng.random((1, s)) > 0.2).astype(np.int32)
        m[:, 40:90] = 0          # a CPN-masked block
        m[:, -11:] = 0           # right pads
        m[:, 0] = 1
    return q, k, v, m, dout


@pytest.fixture(scope="module")
def jax_results():
    cache = {}

    def get(name):
        if name not in cache:
            q, k, v, m, dout = _case(name)
            jm = None if m is None else jnp.asarray(m)
            jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
            lse = None
            if CASES[name] % 128 == 0:
                _, lse = jfa._flash_forward(jq, jk, jv, jm, jm, True, D ** -0.5, 128, 128,
                                            with_lse=True, interpret=True)
                lse = np.asarray(lse)
            out, vjp = jax.vjp(
                lambda a, b, c: jfa.flash_attention(a, b, c, key_mask=jm, query_mask=jm,
                                                    causal=True, interpret=True), jq, jk, jv)
            grads = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
            cache[name] = {"out": np.asarray(out), "lse": lse, "grads": grads}
        return cache[name]

    return get


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _assert_grads(got, want):
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        tol = GRAD_REL * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("name", ["holes", "left_pads", "dense"])
def test_lse_forward_matches_jax_interpret(jax_results, name):
    q, k, v, m, _ = _case(name)
    ref = jax_results(name)
    out, lse = tfa.reference_attention_lse(*_t(q, k, v, m, m), True, D ** -0.5)
    np.testing.assert_allclose(out.numpy(), ref["out"], atol=OUT_ATOL, rtol=OUT_RTOL)
    rows = np.ones(q.shape[1], bool) if m is None else m[0].astype(bool)
    assert lse.shape == (1, HQ, q.shape[1]) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy()[:, :, rows], ref["lse"][:, :, rows], atol=LSE_ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_reference_backward_matches_jax_vjp(jax_results, name):
    q, k, v, m, dout = _case(name)
    ref = jax_results(name)
    tq, tk, tv, tm, tdo = _t(q, k, v, m, dout)
    out, lse = tfa.reference_attention_lse(tq, tk, tv, tm, tm, True, D ** -0.5)
    grads = tfa.reference_attention_backward(tq, tk, tv, tm, tm, out, lse, tdo, True, D ** -0.5)
    _assert_grads(grads, ref["grads"])
    if m is not None:  # masked queries pass no gradient to q
        assert not grads[0].numpy()[m == 0].any()


@pytest.mark.parametrize("name", list(CASES))
def test_function_on_cpu_matches_jax_vjp(jax_results, name):
    q, k, v, m, dout = _case(name)
    ref = jax_results(name)
    tq, tk, tv, tm, tdo = _t(q, k, v, m, dout)
    for t in (tq, tk, tv):
        t.requires_grad_(True)
    tfa.reset_counts()
    out = multi_head_attention(tq, tk, tv, key_mask=tm, query_mask=tm, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    np.testing.assert_allclose(out.detach().numpy(), ref["out"], atol=OUT_ATOL, rtol=OUT_RTOL)
    out.backward(tdo)
    _assert_grads([tq.grad, tk.grad, tv.grad], ref["grads"])
    assert tfa.counts() == {"flash_fwd": 0, "flash_fwd_lse": 0, "flash_fwd_dense": 0,
                            "flash_fwd_dense_lse": 0, "flash_dq": 0, "flash_dkv": 0,
                            "flash_bwd_dense": 0, "flash_bwd_dense_prep": 0,
                            "flash_bwd_dense_convert": 0}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masks", ["both", "key_only", "none"])
def test_plain_backward_equals_autograd_of_plain_forward(causal, masks):
    """Small heads, every mode the Function takes: the explicit backward is
    the gradient of reference_attention (autograd), causal or not, with both
    masks, a key mask alone, or none."""
    rng = np.random.default_rng(3)
    b, s, hq, hkv, d = 2, 24, 4, 2, 16
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32) * 0.5
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32) * 0.5
    dout = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    m = (rng.random((b, s)) > 0.25).astype(np.int32)
    m[:, 0] = 1
    km = None if masks == "none" else torch.from_numpy(m)
    qm = km if masks == "both" else None
    tq, tk, tv, tdo = _t(q, k, v, dout)
    out, lse = tfa.reference_attention_lse(tq, tk, tv, km, qm, causal, 0.3)
    torch.testing.assert_close(out, reference_attention(tq, tk, tv, km, qm, causal, 0.3),
                               rtol=0, atol=0)
    got = tfa.reference_attention_backward(tq, tk, tv, km, qm, out, lse, tdo, causal, 0.3)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    reference_attention(*ts, km, qm, causal, 0.3).backward(tdo)
    _assert_grads(got, [t.grad.numpy() for t in ts])


def test_dispatch_without_grad_keeps_the_inference_path():
    """No gradient needed (grad mode off, or no input requires grad): the
    plain forward on the CPU, no Function in the graph, no launch."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((1, 12, 4, 16), (1, 12, 2, 16), (1, 12, 2, 16)))
    q.requires_grad_(True)
    tfa.reset_counts()
    with torch.no_grad():
        out = multi_head_attention(q, k, v)
    assert out.grad_fn is None
    q.requires_grad_(False)
    assert multi_head_attention(q, k, v).grad_fn is None
    assert sum(tfa.counts().values()) == 0


def test_meta_tensor_needing_grad_raises_instead_of_computing_plain():
    """Off the CPU, a tensor that needs a gradient reaches the kernels or
    raises: the wrapper refuses a device it has no kernel for. A window is
    not such a fallback: the windowed attention is plain torch ops on every
    device (the JAX wrapper runs it as XLA whenever a window is set), so it
    runs there under autograd, launching nothing."""
    q = torch.empty((1, 8, 4, 128), device="meta", requires_grad=True)
    k = torch.empty((1, 8, 2, 128), device="meta", requires_grad=True)
    with pytest.raises(ValueError):
        multi_head_attention(q, k, k)
    before = tfa.counts()
    out = multi_head_attention(q, k, k, window=4)
    assert out.device.type == "meta" and out.grad_fn is not None
    assert tfa.counts() == before
    with pytest.raises(ValueError):
        tfa.flash_attention_backward(q, k, k, None, None, q, q, q)


def test_failed_backward_build_raises(monkeypatch, tmp_path):
    import shutil

    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(tfa, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfa.build(("flash_bwd",))
    assert tfa.library_path("flash_bwd").name == "libflash_bwd.so"
    assert tfa.library_path("flash_bwd").parent.parent == tmp_path
