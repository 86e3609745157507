"""The port's single-image path against the JAX package's, on the CPU: every
anyres helper of blim_tpu_torch/data/images.py (a copy of the host
original) gives exactly the original's result on the same input;
merge_image_patches reassembles tiles in the same raster order exactly;
encode_image_tiles (tower on 1-frame tiles with the image position table,
ToMe to 64, projector mlp) matches within 1e-4 relative (Frobenius) in fp32,
the tolerance of fp32 sums in another order through a 2-block tower, 2 ToMe
rounds and the MLP."""

import base64
import dataclasses
from io import BytesIO

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from blim_tpu.core.config import tiny_model_config as jax_tiny_config
from blim_tpu.data import images as jim
from blim_tpu.models import umt_vit as jvit
from blim_tpu.models import videochat_flash as jvcf

from blim_tpu_torch.checkpoints.convert import params_from_numpy
from blim_tpu_torch.core.config import tiny_model_config
from blim_tpu_torch.data import images as tim
from blim_tpu_torch.kernels import flash_attention as tfa
from blim_tpu_torch.models import umt_vit as tvit
from blim_tpu_torch.models import videochat_flash as tvcf

torch.backends.cuda.matmul.allow_tf32 = False

GRIDS = ["(1x1),...,(3x3)", "(1x1),...,(2x4)", [[448, 896], [896, 448]], "[[448, 448], [896, 896]]"]
SIZES = [(900, 600), (100, 100), (600, 900), (2000, 300), (448, 448), (1344, 897)]


def _image(seed, w, h):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _same(a, b):
    if isinstance(a, Image.Image):
        assert isinstance(b, Image.Image) and a.size == b.size and a.mode == b.mode
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    elif isinstance(a, (list, tuple)) and a and not np.isscalar(a[0]):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("grid", GRIDS, ids=["3x3", "2x4", "list", "literal"])
def test_grid_and_resolution_helpers_match_jax(grid):
    assert tim.parse_grid_pinpoints(grid, 448) == jim.parse_grid_pinpoints(grid, 448)
    possible = jim.parse_grid_pinpoints(grid, 448)
    for size in SIZES:
        for cap in (None, 448 * 448 * 3, 448 * 448 * 7):
            try:
                want = jim.select_best_resolution(size, possible, cap, 448)
            except AssertionError:
                with pytest.raises(AssertionError):
                    tim.select_best_resolution(size, possible, cap, 448)
                continue
            assert tim.select_best_resolution(size, possible, cap, 448) == want
            assert (tim.get_anyres_image_grid_shape(size, grid, 448, cap)
                    == jim.get_anyres_image_grid_shape(size, grid, 448, cap))


@pytest.mark.parametrize("w,h", [(20, 12), (12, 20), (16, 16), (37, 5)])
def test_pil_helpers_match_jax(w, h):
    img = _image(w * h, w, h)
    for target in ((8, 8), (24, 10), (10, 30)):
        _same(tim.resize_and_pad_image(img, target), jim.resize_and_pad_image(img, target))
    _same(tim.divide_to_patches(img, 4), jim.divide_to_patches(img, 4))
    _same(tim.expand2square(img, (123, 4, 250)), jim.expand2square(img, (123, 4, 250)))
    _same(tim.resize_and_center_crop(img, 9), jim.resize_and_center_crop(img, 9))
    _same(tim.auto_pad_images(img, [8, 16, 24]), jim.auto_pad_images(img, [8, 16, 24]))
    for overlap in (0.0, 0.25):
        _same(tim.extract_patches(img, 4, overlap), jim.extract_patches(img, 4, overlap))


def test_misc_helpers_match_jax():
    with pytest.raises(AssertionError):
        tim.auto_pad_images(Image.new("RGB", (8, 8)), [])
    buf = BytesIO()
    Image.fromarray(_image(3, 7, 5)).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    _same(tim.load_image_from_base64(b64), jim.load_image_from_base64(b64))
    for path in ("/ckpts/VideoChat-Flash-7B/", "a/b/checkpoint-500", "plain"):
        assert tim.get_model_name_from_path(path) == jim.get_model_name_from_path(path)


@pytest.mark.parametrize("ratio", [None, "pad", "anyres_nopad"])
def test_process_images_matches_jax(ratio):
    tproc, jproc = tvit.UMTImageProcessor((64, 64)), jvit.UMTImageProcessor((64, 64))
    imgs = [_image(1, 150, 90), _image(2, 150, 90)]
    grid = [[64, 64], [128, 64], [64, 128], [128, 128]]   # the range syntax takes 224+ only
    t = tim.process_images(imgs, tproc, ratio, grid)
    j = jim.process_images(imgs, jproc, ratio, grid)
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t, j)
    if ratio == "anyres_nopad":
        assert t.shape == (2, 1 + 4, 3, 64, 64)      # base + a 2 x 2 grid (150x90 -> 128x128)
    odd = tim.process_images([_image(3, 150, 90), _image(4, 40, 100)], tproc, "anyres_nopad", grid)
    jodd = jim.process_images([_image(3, 150, 90), _image(4, 40, 100)], jproc, "anyres_nopad", grid)
    assert isinstance(odd, list) and len(odd) == len(jodd) == 2
    for a, b in zip(odd, jodd):
        np.testing.assert_array_equal(a, b)


def test_highres_paths_match_jax():
    tproc, jproc = tvit.UMTImageProcessor((4, 4)), jvit.UMTImageProcessor((4, 4))
    img = _image(5, 20, 12)
    np.testing.assert_array_equal(
        tim.process_highres_image(img, tproc, "8,12"), jim.process_highres_image(img, jproc, "8,12"))
    np.testing.assert_array_equal(
        tim.process_highres_image_crop_split(img, 8, 4, tproc),
        jim.process_highres_image_crop_split(img, 8, 4, jproc))


@pytest.mark.parametrize("call", [
    lambda m, p: m.process_images([np.zeros((8, 8, 3), np.uint8)], p, "highres"),
    lambda m, p: m.process_images([np.zeros((8, 8, 3), np.uint8)], p, "crop_split"),
    lambda m, p: m.process_images([np.zeros((8, 8, 3), np.uint8)], p, "anyres"),
    lambda m, p: m.process_anyres_image(np.zeros((8, 8, 3), np.uint8), p, "(1x1),...,(2x2)"),
], ids=["highres", "crop_split", "anyres-padded", "process_anyres_image"])
def test_branches_the_reference_leaves_unimplemented_raise(call):
    for mod, proc in ((jim, jvit.UMTImageProcessor((448, 448))),
                      (tim, tvit.UMTImageProcessor((448, 448)))):
        with pytest.raises(NotImplementedError):
            call(mod, proc)


# ---------------------------------------------------------------------------
# merge_image_patches and encode_image_tiles
# ---------------------------------------------------------------------------

def _merge_both(feat, size, pins, **kw):
    jcfg, tcfg = jax_tiny_config(), tiny_model_config()
    t = tvcf.merge_image_patches(torch.from_numpy(feat), size, tcfg, pins, **kw)
    j = jvcf.merge_image_patches(jnp.asarray(feat), size, jcfg, pins, **kw)
    return t.numpy(), np.asarray(j)


@pytest.mark.parametrize("nph,npw", [(2, 3), (2, 2), (1, 4), (3, 1)])
def test_merge_image_patches_raster_order(nph, npw):
    """Tile (r, c) of the grid lands at rows r*8..r*8+7, columns c*8..c*8+7
    of the merged 8 nph x 8 npw token raster, after the base tile."""
    side = tiny_model_config().vision.image_size
    hw, c = 8, 5
    rng = np.random.default_rng(nph * 10 + npw)
    feat = rng.standard_normal((1 + nph * npw, hw * hw, c)).astype(np.float32)
    size, pins = (npw * side, nph * side), [[npw * side, nph * side]]
    t, j = _merge_both(feat, size, pins)
    np.testing.assert_array_equal(t, j)
    assert t.shape == (hw * hw * (1 + nph * npw), c)
    np.testing.assert_array_equal(t[:hw * hw], feat[0])
    body = t[hw * hw:].reshape(nph, hw, npw, hw, c)
    for r in range(nph):
        for col in range(npw):
            np.testing.assert_array_equal(body[r, :, col],
                                          feat[1 + r * npw + col].reshape(hw, hw, c))
    tn, jn = _merge_both(feat, size, pins, mm_patch_merge_type="spatial_nobase")
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tn, t[hw * hw:])


def test_merge_image_patches_single_tile_and_raising_branches():
    feat = np.random.default_rng(0).standard_normal((1, 64, 7)).astype(np.float32)
    t, j = _merge_both(feat, (64, 64), [[64, 64]])
    np.testing.assert_array_equal(t, j)
    assert t.shape == (64, 7)
    multi = np.zeros((5, 64, 7), np.float32)
    for kw in (dict(mm_patch_merge_type="spatial_unpad"), dict(image_aspect_ratio="pad"),
               dict(mm_patch_merge_type="spatial_maxpool2x2")):
        with pytest.raises(NotImplementedError):
            tvcf.merge_image_patches(torch.from_numpy(multi), (128, 128), tiny_model_config(),
                                     [[128, 128]], **kw)
    with pytest.raises(NotImplementedError):
        tvcf.merge_image_patches(torch.from_numpy(feat), (64, 64), tiny_model_config(), [[64, 64]],
                                 mm_patch_merge_type="spatial_unpad")


def _image_config(make):
    # 192 px tiles: (192 / 16)^2 = 144 patches, compressible to the 64-token target
    cfg = make(image_size=192)
    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, hidden_size=128, num_attention_heads=2), mm_hidden_size=128)


def test_encode_image_tiles_matches_jax():
    jcfg, tcfg = _image_config(jax_tiny_config), _image_config(tiny_model_config)
    jp = jvcf.init_params(jcfg, jax.random.key(0))
    jp["vision_tower"] = jvit.init_params(jcfg.vision, jax.random.key(1))
    rng = np.random.default_rng(3)
    npp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), jp)
    tp = params_from_numpy(npp, torch.float32, "cpu")
    side = tcfg.vision.image_size
    pixels = rng.standard_normal((5, 3, side, side)).astype(np.float32)   # base + 2 x 2 grid
    want = np.asarray(jvcf.encode_image_tiles(jax.tree_util.tree_map(jnp.asarray, npp), jcfg,
                                              jnp.asarray(pixels)))
    tfa.reset_counts()
    got = tvcf.encode_image_tiles(tp, tcfg, pixels, device="cpu")
    assert not any(tfa.counts().values())
    assert got.shape == (5, 64, tcfg.llm.hidden_size) == want.shape
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-4, rel
    merged = tvcf.merge_image_patches(got, (2 * side, 2 * side), tcfg, [[2 * side, 2 * side]])
    jmerged = jvcf.merge_image_patches(jnp.asarray(want), (2 * side, 2 * side), jcfg,
                                       [[2 * side, 2 * side]])
    assert merged.shape == (5 * 64, tcfg.llm.hidden_size)
    np.testing.assert_allclose(merged.numpy(), np.asarray(jmerged), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_encode_image_tiles_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tvcf.encode_image_tiles({"vision_tower": {}}, tiny_model_config(), np.zeros((1, 3, 64, 64)))
