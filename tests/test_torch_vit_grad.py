"""The UMT tower's gradient: the port's plain versions of B2-lse and of the
d = 64 backward (the TPU's dq and dk/dv kernels, one fused kernel on the
card), its autograd Function at head dim 64 and the gradient through its
`umt_vit.encode_clips`, against the JAX package on the CPU in fp32.

B2-lse and the fused backward themselves run only on the card
(chip_smoke.py phase 16 holds them to these plain versions there;
tests/test_torch_flash_schedule.py models the fused kernel's tiles). Here:

  (a) `reference_attention_lse` at d = 64, dense, non-causal, one q head a
      K/V head, on strided views of a packed qkv (as the ViT hands them),
      against the Pallas `_flash_forward(with_lse=True)` in interpret mode at
      (1, 128, 2, 64) with blocks of 64: the dense branch the JAX custom VJP
      runs for the tower (`_vjp_fwd`);
  (b) `reference_attention_backward` against the Pallas `_flash_backward`
      (`_dq_kernel`, `_dkv_kernel`) in interpret mode at the same shape, on
      the same O and lse;
  (c) `multi_head_attention` with a gradient at d = 64 (the Function on CPU
      tensors) against `jax.vjp` of JAX's `multi_head_attention(causal=False)`;
  (d) the gradient of a seeded linear loss through the port's
      `umt_vit.encode_clips` against `jax.grad` through JAX's, with respect
      to the pixels and every leaf of one numpy tree bridged into both
      packages: hidden 128, 2 heads of 64, 2 blocks, image 32, patch 16, 2
      frames;
  (e) which operands the fused backward reads in place (`_in_place`).

Tolerances: fp32 sums in another order. Outputs atol 1e-5 / rtol 1e-4; lse
atol 1e-5 (every row sees every key, |lse| ~ 5); a gradient 1e-4 x max|g|
of its tensor for one attention, 2e-4 through the 2-block tower (two
LayerNorms, the MLP and the attention a block, on the way back).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blim_tpu.core.config import VisionConfig as JVisionConfig
from blim_tpu.kernels import attention as jattention
from blim_tpu.kernels import flash_attention as jfa
from blim_tpu.models import umt_vit as jvit

from blim_tpu_torch.checkpoints.convert import params_from_numpy
from blim_tpu_torch.core.config import VisionConfig
from blim_tpu_torch.kernels import flash_attention as tfa
from blim_tpu_torch.kernels.attention import multi_head_attention
from blim_tpu_torch.models import umt_vit as tvit

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OUT_ATOL, OUT_RTOL = 1e-5, 1e-4
LSE_ATOL = 1e-5
GRAD_REL = 1e-4
TOWER_GRAD_REL = 2e-4
B, S, H, D = 1, 128, 2, 64
BLK = 64
SCALE = D ** -0.5
TINY = dict(image_size=32, patch_size=16, hidden_size=128, num_attention_heads=2,
            num_hidden_layers=3, return_idx=-2, num_frames=2)   # 2 blocks run, d = 64


@pytest.fixture(scope="module")
def packed():
    """q, k, v as (B, S, H, D) slices of one (B, S, 3, H, D) array, and dO."""
    rng = np.random.default_rng(64)
    qkv = rng.standard_normal((B, S, 3, H, D)).astype(np.float32) * 0.5
    dout = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return qkv, dout


@pytest.fixture(scope="module")
def pallas(packed):
    """The Pallas dense forward with lse and backward, in interpret mode."""
    qkv, dout = packed

    @jax.jit
    def forward_backward(a, g):
        q, k, v = a[:, :, 0], a[:, :, 1], a[:, :, 2]
        out, lse = jfa._flash_forward(q, k, v, None, None, False, SCALE, BLK, BLK,
                                      with_lse=True, interpret=True)
        grads = jfa._flash_backward(q, k, v, None, None, out, lse, g, False, SCALE, BLK, BLK,
                                    interpret=True)
        return out, lse, grads

    out, lse, grads = forward_backward(jnp.asarray(qkv), jnp.asarray(dout))
    return np.array(out), np.array(lse), [np.array(g) for g in grads]


def _views(qkv, requires_grad=False):
    t = torch.from_numpy(qkv.copy()).requires_grad_(requires_grad)
    return t, (t[:, :, 0], t[:, :, 1], t[:, :, 2])


def _assert_close_rel(got, want, rel, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    assert scale > 0, f"{name}: a zero reference gradient proves nothing"
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0, err_msg=name)


def test_b2_lse_plain_matches_pallas_dense_forward_with_lse(packed, pallas):
    qkv, _ = packed
    _, (q, k, v) = _views(qkv)
    assert not q.is_contiguous()
    out, lse = tfa.reference_attention_lse(q, k, v, None, None, False, SCALE)
    want_out, want_lse, _ = pallas
    np.testing.assert_allclose(out.numpy(), want_out, atol=OUT_ATOL, rtol=OUT_RTOL)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=LSE_ATOL, rtol=0)


def test_b3_b4_d64_plain_matches_pallas_dense_backward(packed, pallas):
    qkv, dout = packed
    _, (q, k, v) = _views(qkv)
    out, lse, want = pallas
    got = tfa.reference_attention_backward(q, k, v, None, None, torch.from_numpy(out),
                                           torch.from_numpy(lse), torch.from_numpy(dout),
                                           False, SCALE)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _assert_close_rel(g, w, GRAD_REL, name)


def test_function_at_head_dim_64_matches_jax_vjp(packed):
    """The ViT's call: strided views of a packed qkv that needs a gradient,
    causal=False, no masks. On the CPU it is the Function's plain ends, and
    no kernel launches."""
    qkv, dout = packed
    t, (q, k, v) = _views(qkv, requires_grad=True)
    tfa.reset_counts()
    out = multi_head_attention(q, k, v, causal=False, scale=SCALE)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    out.backward(torch.from_numpy(dout))
    assert not any(tfa.counts().values())

    def f(a):
        return jattention.multi_head_attention(a[:, :, 0], a[:, :, 1], a[:, :, 2], causal=False,
                                               scale=SCALE)

    @jax.jit
    def value_and_vjp(a, g):
        want, vjp = jax.vjp(f, a)
        return want, vjp(g)[0]

    want, want_g = value_and_vjp(jnp.asarray(qkv), jnp.asarray(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=OUT_ATOL,
                               rtol=OUT_RTOL)
    want_g = np.asarray(want_g)
    for i, name in enumerate(("dq", "dk", "dv")):
        _assert_close_rel(t.grad[:, :, i], want_g[:, :, i], GRAD_REL, name)


def _leaf_paths(tree, prefix=()):
    for key, node in tree.items():
        if isinstance(node, dict):
            yield from _leaf_paths(node, prefix + (key,))
        else:
            yield prefix + (key,)


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _seeded_tree(jcfg, rng):
    """A numpy tree of the JAX tower's shapes (from `jax.eval_shape`, which
    runs no init): kernels N(0, 1/fan_in), norm scales 1 + 0.05 N(0, 1) and
    every bias 0.05 N(0, 1), so that no leaf is zero or one and each leaf's
    gradient depends on the others."""
    def leaf(path, a):
        name = path[-1].key
        x = rng.standard_normal(a.shape).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(a.shape[1:-1])) if a.ndim == 5 else a.shape[-2]
            return x / np.float32(np.sqrt(fan_in))
        return (1.0 if name == "scale" else 0.0) + np.float32(0.05) * x

    shapes = jax.eval_shape(lambda: jvit.init_params(jcfg, jax.random.key(1)))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_tower_gradient_matches_jax_grad():
    jcfg, tcfg = JVisionConfig(**TINY), VisionConfig(**TINY)
    rng = np.random.default_rng(12)
    tree = _seeded_tree(jcfg, rng)
    pos = np.asarray(jvit.build_pos_tables(jcfg)[0], np.float32)
    clips = rng.standard_normal((2, 2, 3, 32, 32)).astype(np.float32)   # (B, T, C, H, W)
    n_tokens = tcfg.num_frames * tcfg.patches_per_frame
    w = rng.standard_normal((2, n_tokens, 128)).astype(np.float32)

    def jloss(params, px):
        return jnp.sum(jvit.encode_clips(params, px, jnp.asarray(pos), jcfg) * w)

    want_loss, (want_tree, want_px) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(clips))

    tp = params_from_numpy(tree, torch.float32, "cpu")
    paths = list(_leaf_paths(tp))
    leaves = [_get(tp, p).requires_grad_(True) for p in paths]
    px = torch.from_numpy(clips).requires_grad_(True)
    tfa.reset_counts()
    loss = (tvit.encode_clips(tp, px, pos, tcfg) * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, [px] + leaves)
    assert not any(tfa.counts().values())
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_close_rel(grads[0], np.asarray(want_px), TOWER_GRAD_REL, "pixels")
    assert len(paths) == len(jax.tree_util.tree_leaves(want_tree))
    for path, g in zip(paths, grads[1:]):
        _assert_close_rel(g, np.asarray(_get(want_tree, path)), TOWER_GRAD_REL, "/".join(path))


def test_dense_backward_reads_the_towers_views_in_place(packed):
    """The fused d = 64 backward's TMA maps and 16-byte loads take the
    tower's q, k, v (slices of the packed qkv) and a contiguous dO as they
    are; a dO or O whose last dim is strided, or whose other strides are no
    multiple of 8 elements, is copied to a contiguous tensor first."""
    qkv, dout = packed
    t, (q, k, v) = _views(qkv.astype(np.float32))
    for view in (q, k, v):
        assert tfa._in_place(view) is view
    g = torch.from_numpy(dout.copy())
    assert tfa._in_place(g) is g
    for odd in (g.transpose(-1, -2), torch.zeros((B, S, H, D + 4))[..., :D]):
        copied = tfa._in_place(odd)
        assert copied is not odd and copied.is_contiguous() and torch.equal(copied, odd)
