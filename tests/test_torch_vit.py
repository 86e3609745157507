"""The port's UMT ViT tower, ToMe and B2's plain version against the JAX
package, on the CPU.

Inputs come from numpy seeds; both sides run in fp32 on the same weights
(the JAX init bridged with params_from_numpy). The vision config has 2 heads
of 64, so every attention has B2's head dim. Tolerances: a single op (patch
embed, attention) within atol 2e-5 / rtol 1e-4 (fp32 sums in another
order); a block or the 2-block tower within atol 1e-4 / rtol 1e-4 (the same,
through two LayerNorms and the MLP, on outputs of order 1).

B2 itself runs only on the card (chip_smoke.py phase 8); here its plain
version, reference_attention(causal=False) without masks, is held to the
Pallas kernel in interpret mode at d = 64, S = 256, Hq = 16: S * Hq = 4096
passes the JAX wrapper's small-problem gate, so the Pallas dense branch
with its unrolled KV loop runs.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blim_tpu.checkpoints import convert as jconvert
from blim_tpu.core.config import VisionConfig as JVisionConfig
from blim_tpu.kernels import flash_attention as jfa
from blim_tpu.models import projector as jprojector
from blim_tpu.models import umt_vit as jvit

from blim_tpu_torch.checkpoints import convert as tconvert
from blim_tpu_torch.checkpoints.convert import params_from_numpy
from blim_tpu_torch.core.config import VisionConfig
from blim_tpu_torch.kernels import flash_attention as tfa
from blim_tpu_torch.kernels.attention import multi_head_attention, reference_attention
from blim_tpu_torch.models import projector as tprojector
from blim_tpu_torch.models import umt_vit as tvit

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OP_TOL = dict(atol=2e-5, rtol=1e-4)
TOWER_TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = dict(image_size=64, hidden_size=128, num_attention_heads=2, num_hidden_layers=3,
             return_idx=-2, num_frames=2)  # 2 blocks run, 16 patches a frame, d = 64


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tower():
    jcfg, tcfg = JVisionConfig(**SMALL), VisionConfig(**SMALL)
    jp = jvit.init_params(jcfg, jax.random.key(0))
    # the JAX init has zero biases and unit norms: give every leaf values
    # so that each of them reaches the comparison
    rng = np.random.default_rng(11)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), jp)
    return jcfg, tcfg, jp, params_from_numpy(jp, torch.float32, "cpu")


def _pixels(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# host helpers (numpy copies)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(), SMALL, dict(image_size=224)],
                         ids=["res448", "small", "res224"])
def test_pos_tables_match_jax(cfg):
    for t, j in zip(tvit.build_pos_tables(VisionConfig(**cfg)),
                    jvit.build_pos_tables(JVisionConfig(**cfg))):
        assert t.shape == j.shape
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("n_in,n_out", [(14, 28), (14, 8), (240, 448), (320, 448), (70, 32)])
def test_resize_matrices_match_jax(n_in, n_out):
    for name in ("pil_resize_matrix", "cubic_resize_matrix", "_linear_resize_matrix"):
        np.testing.assert_array_equal(getattr(tvit, name)(n_in, n_out),
                                      getattr(jvit, name)(n_in, n_out), err_msg=name)
    x = np.linspace(-2.5, 2.5, 41)
    for a in (-0.75, -0.5):
        np.testing.assert_array_equal(tvit._cubic_kernel(x, a), jvit._cubic_kernel(x, a))


@pytest.mark.parametrize("no_pil", [False, True])
def test_image_processor_matches_jax(monkeypatch, no_pil):
    import sys

    if no_pil:
        monkeypatch.setitem(sys.modules, "PIL", None)   # the numpy PIL-exact path
    frames = np.random.default_rng(5).integers(0, 256, (2, 26, 34, 3), dtype=np.uint8)
    t, j = tvit.UMTImageProcessor((20, 16)), jvit.UMTImageProcessor((20, 16))
    np.testing.assert_array_equal(t.resize_frames(frames), j.resize_frames(frames))
    np.testing.assert_array_equal(t.preprocess(frames), j.preprocess(frames))
    np.testing.assert_array_equal(tvit.IMAGENET_MEAN, jvit.IMAGENET_MEAN)
    np.testing.assert_array_equal(tvit.IMAGENET_STD, jvit.IMAGENET_STD)


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------

def test_patch_embed_matches_jax(tower):
    jcfg, tcfg, jp, tp = tower
    px = _pixels(1, (3, 3, 2, 64, 64))
    want = np.asarray(jvit.patch_embed(jp, jnp.asarray(px), jcfg))
    got = tvit.patch_embed(tp, torch.from_numpy(px), tcfg).numpy()
    assert got.shape == (3, 2 * 16, 128)
    np.testing.assert_allclose(got, want, **OP_TOL)


def test_vit_block_matches_jax(tower):
    jcfg, tcfg, jp, tp = tower
    x = _pixels(2, (2, 32, 128))
    for i in range(jcfg.depth):
        jb = jax.tree_util.tree_map(lambda a: a[i], jp["blocks"])
        want = np.asarray(jvit.vit_block(jb, jnp.asarray(x), jcfg))
        got = tvit.vit_block(tvit._block_params(tp["blocks"], i), torch.from_numpy(x), tcfg)
        np.testing.assert_allclose(got.numpy(), want, **TOWER_TOL)


def test_forward_features_and_encode_clips_match_jax(tower):
    jcfg, tcfg, jp, tp = tower
    pos, _ = jvit.build_pos_tables(jcfg)
    pos32 = np.asarray(pos, np.float32)
    clips = _pixels(3, (3, 2, 3, 64, 64))                          # (B, T, C, H, W)
    want = np.asarray(jvit.encode_clips(jp, jnp.asarray(clips), jnp.asarray(pos32), jcfg))
    got = tvit.encode_clips(tp, torch.from_numpy(clips), pos32, tcfg).numpy()
    assert got.shape == (3, 32, 128)
    np.testing.assert_allclose(got, want, **TOWER_TOL)
    # forward_features takes (B, C, T, H, W) and a tensor table as well
    ff = tvit.forward_features(tp, torch.from_numpy(clips).transpose(1, 2),
                               torch.from_numpy(pos32), tcfg)
    torch.testing.assert_close(ff, torch.from_numpy(got), rtol=0, atol=0)


def test_tower_never_launches_a_kernel_on_cpu(tower):
    _, tcfg, _, tp = tower
    pos, _ = tvit.build_pos_tables(tcfg)
    tfa.reset_counts()
    tvit.encode_clips(tp, torch.from_numpy(_pixels(4, (1, 2, 3, 64, 64))), pos, tcfg)
    assert not any(tfa.counts().values())


# ---------------------------------------------------------------------------
# weights: seeded init and the HF conversion
# ---------------------------------------------------------------------------

def test_init_vision_tower_matches_jax_shapes_and_scales():
    cfg = VisionConfig(**SMALL)
    t = tconvert.init_vision_tower(cfg, seed=0, dtype=torch.float32, device="cpu")
    j = _np_tree(jvit.init_params(JVisionConfig(**SMALL), jax.random.key(0)))
    tl = dict(jax.tree_util.tree_flatten_with_path(t)[0])
    jl = dict(jax.tree_util.tree_flatten_with_path(j)[0])
    assert tl.keys() == jl.keys()
    for path, jv in jl.items():
        tv = tl[path].numpy()
        assert tv.shape == jv.shape, path
        if (jv == jv.flat[0]).all():                   # constants: biases, norms
            np.testing.assert_array_equal(tv, jv, err_msg=str(path))
        else:                                          # Glorot normal, same scale
            np.testing.assert_allclose(tv.std(), jv.std(), rtol=0.1, err_msg=str(path))
    again = tconvert.init_vision_tower(cfg, seed=0, dtype=torch.float32, device="cpu")
    torch.testing.assert_close(again["blocks"]["qkv"]["kernel"], t["blocks"]["qkv"]["kernel"],
                               rtol=0, atol=0)
    bf = tconvert.init_vision_tower(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    assert bf["blocks"]["fc1"]["kernel"].dtype == torch.bfloat16


def _hf_vit_state_dict(cfg, seed, qv_bias=True):
    """A synthetic HF UMT tower state dict (torch layouts: Linear (out, in),
    Conv3d (out, in, t, h, w))."""
    rng = np.random.default_rng(seed)
    D, I = cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio)
    pre = "model.vision_tower.vision_tower.encoder."
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    sd = {pre + "patch_embed.proj.weight": t(D, 3, cfg.tubelet_size, cfg.patch_size,
                                             cfg.patch_size),
          pre + "patch_embed.proj.bias": t(D),
          pre + "vision_layernorm.weight": t(D), pre + "vision_layernorm.bias": t(D)}
    for i in range(cfg.depth + 1):                 # one block past the truncation
        b = f"{pre}blocks.{i}."
        sd.update({b + "norm1.weight": t(D), b + "norm1.bias": t(D), b + "norm2.weight": t(D),
                   b + "norm2.bias": t(D), b + "attn.qkv.weight": t(3 * D, D),
                   b + "attn.proj.weight": t(D, D), b + "attn.proj.bias": t(D),
                   b + "mlp.fc1.weight": t(I, D), b + "mlp.fc1.bias": t(I),
                   b + "mlp.fc2.weight": t(D, I), b + "mlp.fc2.bias": t(D)})
        if qv_bias:
            sd.update({b + "attn.q_bias": t(D), b + "attn.v_bias": t(D)})
    return sd


@pytest.mark.parametrize("qv_bias", [True, False])
def test_convert_vision_tower_matches_jax(qv_bias):
    cfg = VisionConfig(**SMALL)
    sd = _hf_vit_state_dict(cfg, 3, qv_bias)
    t = tconvert.convert_vision_tower(sd, cfg)
    j = jconvert.convert_vision_tower(sd, JVisionConfig(**SMALL))
    tl = dict(jax.tree_util.tree_flatten_with_path(t)[0])
    jl = dict(jax.tree_util.tree_flatten_with_path(j)[0])
    assert tl.keys() == jl.keys()
    for path in jl:
        np.testing.assert_array_equal(tl[path], jl[path], err_msg=str(path))
    assert t["patch_embed"]["kernel"].shape == (1, 16, 16, 3, 128)


def test_converted_patch_embed_matches_torch_conv3d():
    """The (out, in, t, h, w) -> (t, h, w, in, out) transpose makes the port's
    reshape-and-matmul patch embed equal the HF tower's Conv3d."""
    cfg = VisionConfig(**SMALL)
    sd = _hf_vit_state_dict(cfg, 4)
    tp = params_from_numpy(tconvert.convert_vision_tower(sd, cfg), torch.float32, "cpu")
    pre = "model.vision_tower.vision_tower.encoder.patch_embed.proj."
    conv = torch.nn.Conv3d(3, 128, kernel_size=(1, 16, 16), stride=(1, 16, 16))
    with torch.no_grad():
        conv.weight.copy_(sd[pre + "weight"])
        conv.bias.copy_(sd[pre + "bias"])
        px = torch.from_numpy(_pixels(5, (2, 3, 2, 64, 64)))
        want = conv(px).flatten(2).transpose(1, 2)
    torch.testing.assert_close(tvit.patch_embed(tp, px, cfg), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# B2's plain version, and the dispatch around it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["flash_attention_dense", "multi_head_attention"])
def test_b2_plain_matches_pallas_dense_kernel_interpret(rng, entry):
    b, s, h, d = 1, 256, 16, 64
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) * 0.3 for _ in range(3))
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=False, interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tfa.reset_counts()
    if entry == "flash_attention_dense":
        got = tfa.flash_attention_dense(tq, tk, tv)
    else:
        got = multi_head_attention(tq, tk, tv, causal=False, scale=d ** -0.5)
    assert not any(tfa.counts().values())
    np.testing.assert_allclose(got.numpy(), want, **OP_TOL)


def test_b2_plain_reads_strided_views_of_a_packed_qkv(rng):
    """The ViT hands B2 slices of one (B, S, 3, H, d) projection."""
    qkv = torch.from_numpy(rng.standard_normal((2, 40, 3, 2, 64)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    got = tfa.flash_attention_dense(q, k, v)
    want = reference_attention(q.contiguous(), k.contiguous(), v.contiguous(), None, None,
                               False, 64 ** -0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_head_dim_64_dispatch_off_the_cpu():
    """Off the CPU a d = 64 tensor goes to the kernels or raises. Dense and
    non-causal with a gradient it reaches B2-lse's launch (which refuses a
    meta tensor); with masks or causal and a gradient it raises naming the
    head dim, since the d = 64 kernels take only the ViT's mode; without a
    gradient it goes to B2, and B1 refuses d = 64 (masks or causal)."""
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        multi_head_attention(q.requires_grad_(True), q, q, causal=False)
    mask = torch.ones((1, 8), dtype=torch.int32, device="meta")
    for kw in (dict(causal=True), dict(causal=False, key_mask=mask),
               dict(causal=False, query_mask=mask)):
        with pytest.raises(ValueError, match="head dim 64"):
            multi_head_attention(q, q, q, **kw)
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        multi_head_attention(q, q, q, causal=False)           # -> B2, refuses meta
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfa.flash_attention_dense(q, q, q)


def test_operand_checks_name_the_head_dim():
    t = torch.empty((1, 8, 2, 64), dtype=torch.bfloat16)
    tfa._check_operand("q", t, t.device, tfa.DENSE_HEAD_DIM)
    with pytest.raises(ValueError, match="128"):
        tfa._check_operand("q", t, t.device)
    with pytest.raises(ValueError, match="64"):
        tfa._check_operand("q", torch.empty((1, 8, 2, 32), dtype=torch.bfloat16), t.device,
                           tfa.DENSE_HEAD_DIM)


def test_counts_report_b2():
    tfa.reset_counts()
    assert tfa.counts() == {"flash_fwd": 0, "flash_fwd_lse": 0, "flash_fwd_dense": 0,
                            "flash_fwd_dense_lse": 0, "flash_dq": 0, "flash_dkv": 0,
                            "flash_bwd_dense": 0, "flash_bwd_dense_prep": 0,
                            "flash_bwd_dense_convert": 0}


# ---------------------------------------------------------------------------
# ToMe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,target", [(3136, 64), (784, 64), (65, 64), (64, 16), (8, 4),
                                      (200, 33), (1000, 7), (17, 1)])
def test_merge_schedule_matches_jax(t, target):
    assert tprojector.merge_schedule(t, target) == jprojector.merge_schedule(t, target)
    assert t - sum(tprojector.merge_schedule(t, target)) == target


def test_merge_schedule_full_width_and_refusal():
    assert tprojector.merge_schedule(3136, 64) == [1568, 784, 392, 196, 98, 34]
    with pytest.raises(AssertionError):
        tprojector.merge_schedule(64, 64)


@pytest.mark.parametrize("b,t,c,heads,r", [(3, 64, 32, 4, 20), (2, 33, 16, 2, 16),
                                           (1, 128, 128, 2, 64)])
def test_bipartite_merge_indices_match_jax(rng, b, t, c, heads, r):
    metric = rng.standard_normal((b, t, c)).astype(np.float32)
    want = jprojector._bipartite_merge_indices(jnp.asarray(metric), r)
    got = tprojector._bipartite_merge_indices(torch.from_numpy(metric), r)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    np.testing.assert_allclose(
        tprojector._merge_sum(torch.from_numpy(x), *got).numpy(),
        np.asarray(jprojector._merge_sum(jnp.asarray(x), *want)), **OP_TOL)


def test_tome_ties_resolve_like_jax():
    """Exact ties in node_max keep index order, as the stable argsort of the
    negated keys does in JAX, and argmax takes the first maximum in both.
    Every token has four entries of +-1 and norm 2, so each similarity is a
    multiple of 1/4, exact in fp32 whatever the order of the sums."""
    rng = np.random.default_rng(7)
    metric = np.zeros((2, 24, 8), np.float32)
    for i in range(2):
        for j in range(24):
            metric[i, j, rng.choice(8, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
    want = jprojector._bipartite_merge_indices(jnp.asarray(metric), 5)
    got = tprojector._bipartite_merge_indices(torch.from_numpy(metric), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("b,t,c,heads,target", [(3, 64, 32, 4, 16), (2, 200, 64, 2, 24),
                                                (2, 32, 128, 2, 4)])
def test_merge_tokens_matches_jax(rng, b, t, c, heads, target):
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    want = np.asarray(jprojector.merge_tokens(jnp.asarray(x), target, heads))
    got = tprojector.merge_tokens(torch.from_numpy(x), target, heads).numpy()
    assert got.shape == (b, target, c)
    np.testing.assert_allclose(got, want, **OP_TOL)


def test_compress_clip_and_image_tokens_match_jax(rng):
    x = rng.standard_normal((2, 2 * 16, 128)).astype(np.float32)
    want = jprojector.compress_clip_tokens(jnp.asarray(x), 2, 2, 2)
    got = tprojector.compress_clip_tokens(torch.from_numpy(x), 2, 2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    img = rng.standard_normal((2, 100, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tprojector.compress_image_tokens(torch.from_numpy(img), 2, target=10).numpy(),
        np.asarray(jprojector.compress_image_tokens(jnp.asarray(img), 2, target=10)),
        **OP_TOL)


def test_tome_keeps_bf16_and_sizes_sum(rng):
    """ToMe runs in x's dtype; each output token is the mean of the tokens
    merged into it, so a constant input stays constant."""
    x = torch.from_numpy(rng.standard_normal((2, 64, 32)).astype(np.float32)).bfloat16()
    assert tprojector.merge_tokens(x, 16, 4).dtype == torch.bfloat16
    const = torch.full((1, 64, 32), 3.0)
    const[:, :, 0] = torch.arange(64.0) * 1e-3                 # break exact ties
    out = tprojector.merge_tokens(const, 16, 4)
    torch.testing.assert_close(out[..., 1:], torch.full((1, 16, 31), 3.0))
