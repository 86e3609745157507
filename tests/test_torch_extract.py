"""The port's extraction slice against the JAX package's, on the CPU in fp32.

The whole-slice test: the port's featurizer (tower + ToMe, with and without
on-device preprocessing, with raw frames smaller than the tower size so that
the resize runs) and its run_extraction pipeline give the JAX package's
features for the same frames and weights. Also the host pieces: readers,
the decode prefetcher, chunking, the upload rule, the feature store, and
main() over a gif and a frame directory.

Tolerances: features after the 2-block tower and 3 ToMe rounds within atol
1e-4 / rtol 1e-4 (fp32 sums in another order, outputs of order 1); the
on-device resize equal to the host's float64 two-pass resize (both round
to integers: the fp32 products stay within 1e-3 of them, far from a
half-integer unless a tie sits there, which a test with integer frames
would show as a difference of exactly 1 grey level).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blim_tpu.core.config import ModelConfig as JModelConfig
from blim_tpu.core.config import VisionConfig as JVisionConfig
from blim_tpu.data.features import FeatureStore as JFeatureStore
from blim_tpu.models import umt_vit as jvit
from blim_tpu.pipelines import extract as jex

from blim_tpu_torch.checkpoints.convert import params_from_numpy
from blim_tpu_torch.core.config import ModelConfig, VisionConfig
from blim_tpu_torch.data.features import FeatureStore
from blim_tpu_torch.kernels import flash_attention as tfa
from blim_tpu_torch.models import umt_vit as tvit
from blim_tpu_torch.pipelines import extract as tex

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(atol=1e-4, rtol=1e-4)
VISION = dict(image_size=64, hidden_size=128, num_attention_heads=2, num_hidden_layers=3,
              return_idx=-2, num_frames=2)       # 2 blocks, 2 heads of 64, 32 tokens a clip
MODEL = dict(mm_hidden_size=128, mm_local_num_frames=2, num_clips=2, tokens_per_frame=2)


@pytest.fixture(scope="module")
def setup():
    jcfg = JModelConfig(vision=JVisionConfig(**VISION), **MODEL)
    tcfg = ModelConfig(vision=VisionConfig(**VISION), **MODEL)
    jp = jvit.init_params(jcfg.vision, jax.random.key(0))
    rng = np.random.default_rng(21)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), jp)
    tp = params_from_numpy(jp, torch.float32, "cpu")
    return jcfg, tcfg, jp, tp


def _frames(seed, b, h, w, cfg):
    t = cfg.num_clips * cfg.mm_local_num_frames
    return np.random.default_rng(seed).integers(0, 256, (b, t, h, w, 3), dtype=np.uint8)


def _as_clips(frames, cfg):
    b, t = frames.shape[:2]
    return frames.reshape(b, cfg.num_clips, cfg.mm_local_num_frames, *frames.shape[2:])


# ---------------------------------------------------------------------------
# the featurizer (whole slice)
# ---------------------------------------------------------------------------

def test_featurizer_host_preprocess_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    proc = tvit.UMTImageProcessor((64, 64))
    frames = _frames(1, 2, 64, 64, tcfg)
    pixels = np.stack([proc.preprocess(f) for f in frames])            # (B, T, 3, h, w)
    pixels = pixels.reshape(2, tcfg.num_clips, tcfg.mm_local_num_frames, 3, 64, 64)
    want = np.asarray(jex.make_featurizer(jp, jcfg)(jnp.asarray(pixels)))
    tfa.reset_counts()
    got = tex.make_featurizer(tp, tcfg, device="cpu")(torch.from_numpy(pixels))
    assert not any(tfa.counts().values())
    assert got.shape == (2, tcfg.num_clips, tcfg.tokens_per_clip, 128)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("hw", [(64, 64), (40, 52), (30, 64)], ids=["tower-size", "smaller",
                                                                     "mixed"])
def test_featurizer_device_preprocess_matches_jax(setup, hw):
    """uint8 channels-last frames; at a size other than the tower's the
    featurizer resizes them itself before it normalises."""
    jcfg, tcfg, jp, tp = setup
    raw = _as_clips(_frames(2, 2, *hw, tcfg), tcfg)
    want = np.asarray(jex.make_featurizer(jp, jcfg, device_preprocess=True)(jnp.asarray(raw)))
    got = tex.make_featurizer(tp, tcfg, device="cpu", device_preprocess=True)(
        torch.from_numpy(raw))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_device_preprocess_equals_host_preprocess(setup):
    """On the card or not, the featurizer's own preprocessing is the host
    processor's: same features from raw uint8 and from host-normalised
    pixels of the host-resized frames."""
    _, tcfg, _, tp = setup
    raw = _frames(3, 1, 40, 52, tcfg)
    proc = tvit.UMTImageProcessor((64, 64))
    with pytest.MonkeyPatch.context() as mp:
        import sys

        mp.setitem(sys.modules, "PIL", None)     # the host's PIL-exact numpy resize
        host = np.stack([proc.preprocess(f) for f in raw])
    host = host.reshape(1, tcfg.num_clips, tcfg.mm_local_num_frames, 3, 64, 64)
    a = tex.make_featurizer(tp, tcfg, device="cpu")(torch.from_numpy(host))
    b = tex.make_featurizer(tp, tcfg, device="cpu", device_preprocess=True)(
        torch.from_numpy(_as_clips(raw, tcfg)))
    torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("hw_in,size", [((40, 52), 64), ((240, 320), 448), ((70, 50), 32)])
def test_device_resize_matches_host_two_pass_resize(hw_in, size):
    frames = np.random.default_rng(4).integers(0, 256, (3, *hw_in, 3), dtype=np.uint8)
    mh = tvit.pil_resize_matrix(hw_in[0], size)
    mw = tvit.pil_resize_matrix(hw_in[1], size)
    want = []
    for f in frames:
        t = np.clip(np.rint(np.einsum("ow,hwc->hoc", mw, f.astype(np.float64))), 0, 255)
        want.append(np.clip(np.rint(np.einsum("oh,hwc->owc", mh, t)), 0, 255))
    got = tex.device_resize(torch.from_numpy(frames).float(), size).numpy()
    d = np.abs(got - np.stack(want))
    assert got.shape == (3, size, size, 3)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def test_device_resize_refuses_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="full fp32"):
        tex._check_full_fp32_matmul()


def test_featurizer_keeps_the_parameters_dtype(setup):
    _, tcfg, _, tp = setup
    bf = jax.tree_util.tree_map(lambda t: t.bfloat16(), tp)
    raw = torch.from_numpy(_as_clips(_frames(5, 1, 40, 52, tcfg), tcfg))
    out = tex.make_featurizer(bf, tcfg, device="cpu", device_preprocess=True)(raw)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


# ---------------------------------------------------------------------------
# run_extraction: buckets, tail padding, order, against the JAX pipeline
# ---------------------------------------------------------------------------

SHAPES = {"a": (40, 52), "b": (64, 64)}
ORDER = ["a0", "b0", "a1", "a2", "bad", "b1", "a3", "b2"]


def _decode(cfg):
    def decode(p):
        if p == "bad":
            raise ValueError("corrupt")
        t = cfg.num_clips * cfg.mm_local_num_frames
        rng = np.random.default_rng(sum(map(ord, p)))
        return rng.integers(0, 256, (t, *SHAPES[p[0]], 3), dtype=np.uint8)
    return decode


def _run(ex, featurize, cfg, to_np, **kw):
    batches, consumed, logs = [], [], []

    def feat(dev):
        batches.append(tuple(dev.shape))
        return featurize(dev)

    def on_features(paths, feats):
        assert feats.shape[0] == len(paths)
        consumed.extend(zip(paths, to_np(feats)))

    n_ok, _ = ex.run_extraction(ORDER, _decode(cfg), feat, on_features, batch_size=2,
                                clips=cfg.num_clips, local_frames=cfg.mm_local_num_frames,
                                decode_workers=3, save_iter=100, log=logs.append, **kw)
    return n_ok, batches, consumed, logs


def test_run_extraction_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    jn, jb, jc, jl = _run(jex, jex.make_featurizer(jp, jcfg, device_preprocess=True), jcfg,
                          lambda f: np.asarray(f, np.float32))
    tn, tb, tc, tl = _run(tex, tex.make_featurizer(tp, tcfg, device="cpu",
                                                   device_preprocess=True),
                          tcfg, lambda f: f.float().numpy(), device="cpu")
    assert tn == jn == len(ORDER) - 1
    assert tb == jb                      # the same batches, in the same order and shapes
    assert [p for p, _ in tc] == [p for p, _ in jc]
    for (p, t), (_, j) in zip(tc, jc):
        np.testing.assert_allclose(t, j, err_msg=p, **TOL)
    assert [m for m in tl if "Error" in m] == [m for m in jl if "Error" in m]


def test_run_extraction_buckets_pads_and_orders(setup):
    _, tcfg, _, _ = setup
    seen = []

    def featurize(dev):
        seen.append(dev)
        return dev.float().mean(dim=(2, 3, 4, 5))   # one number per (video, clip)

    n_ok, batches, consumed, logs = _run(tex, featurize, tcfg, lambda f: f.numpy(),
                                         device="cpu")
    assert n_ok == 7 and any("bad" in m for m in logs)
    # a: 4 videos -> 2 full batches; b: 3 videos -> 1 full + 1 padded tail,
    # each dispatched when it fills
    a, b = (2, 2, 2, 40, 52, 3), (2, 2, 2, 64, 64, 3)
    assert batches == [a, b, a, b]
    assert all(d.dtype == torch.uint8 for d in seen)
    assert [p for p, _ in consumed] == ["a0", "a1", "b0", "b1", "a2", "a3", "b2"]
    tail = seen[-1]
    torch.testing.assert_close(tail[0], tail[1], rtol=0, atol=0)  # padded with the last video
    decode = _decode(tcfg)
    for p, f in consumed:
        want = decode(p).reshape(tcfg.num_clips, -1).astype(np.float64).mean(axis=1)
        np.testing.assert_allclose(f, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vlen", [1, 3, 16, 17, 353])
def test_middle_frame_indices_match_jax(vlen):
    for n in (8, 16):
        np.testing.assert_array_equal(tex.middle_frame_indices(n, vlen),
                                      jex.middle_frame_indices(n, vlen))


def test_chunk_list_matches_jax():
    items = [f"v{i}" for i in range(23)]
    for n in (1, 2, 4, 7):
        for i in range(n):
            assert tex.chunk_list(items, n, i) == jex.chunk_list(items, n, i)


def test_resize_for_upload_rule():
    proc = tvit.UMTImageProcessor(size=(32, 32))
    rng = np.random.default_rng(0)
    small = rng.integers(0, 256, (2, 20, 24, 3), dtype=np.uint8)
    assert tex.resize_for_upload(small, proc, (32, 32)) is small
    big = rng.integers(0, 256, (2, 80, 60, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tex.resize_for_upload(big, proc, (32, 32)),
                                  jex.resize_for_upload(big, jvit.UMTImageProcessor((32, 32)),
                                                        (32, 32)))


def test_decode_prefetcher_order_and_errors():
    import time

    def decode(p):
        time.sleep(0.01 * (int(p) % 3))
        if p == "4":
            raise ValueError("corrupt")
        return int(p) * 10

    paths = [str(i) for i in range(9)]
    got = list(tex.DecodePrefetcher(paths, decode, workers=3, depth=4))
    assert [p for p, _, _ in got] == paths
    for p, val, err in got:
        if p == "4":
            assert isinstance(err, ValueError) and val is None
        else:
            assert err is None and val == int(p) * 10


def _make_gif(path, n, size=(24, 20)):
    import imageio

    imageio.mimsave(path, [np.full((*size, 3), i * 5, np.uint8) for i in range(n)],
                    duration=0.1)


def _make_frame_dir(root, n):
    import cv2

    os.makedirs(root, exist_ok=True)
    for i in range(n):
        cv2.imwrite(os.path.join(root, f"frame_{i:04d}.jpg"), np.full((16, 18, 3), i * 7, np.uint8))


def test_readers_match_jax(tmp_path):
    gif, frames = str(tmp_path / "v.gif"), str(tmp_path / "frames")
    _make_gif(gif, 12)
    _make_frame_dir(frames, 10)
    for path in (gif, frames):
        for n in (4, 8, 16):
            np.testing.assert_array_equal(tex.read_frames(path, n), jex.read_frames(path, n))


def test_feature_store_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((3, 4, 8, 16)).astype(np.float32)
    vids = ["v0", "v1", "v2"]
    store = FeatureStore(str(tmp_path), shape=(4, 8, 16))
    for v, f in zip(vids, feats):
        store.save(v, f)
    for v, f in zip(vids, feats):
        assert store.available(v)
        np.testing.assert_array_equal(store.load(v), f.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(store.load("missing"), np.zeros((4, 8, 16), np.float32))
    assert not store.available("missing")
    j = JFeatureStore(str(tmp_path), shape=(4, 8, 16))
    np.testing.assert_array_equal(store.load_many(vids + ["missing"]),
                                  j.load_many(vids + ["missing"]))
    pack = tmp_path / "packed"
    pack.mkdir()
    FeatureStore.write_pack(str(pack), vids, feats)
    jpack = tmp_path / "jpacked"
    jpack.mkdir()
    JFeatureStore.write_pack(str(jpack), vids, feats)
    for name in ("features.pack", "features.idx.json"):
        assert (pack / name).read_bytes() == (jpack / name).read_bytes()
    t, j = FeatureStore(str(pack)), JFeatureStore(str(pack))
    assert t.shape == j.shape == (4, 8, 16)
    np.testing.assert_array_equal(t.load_many(["v2", "v0"]), j.load_many(["v2", "v0"]))
    np.testing.assert_array_equal(t.load("v1"), j.load("v1"))


def test_feature_store_reads_pth(tmp_path):
    f = torch.randn(4, 8, 16).half()
    torch.save(f, tmp_path / "x.pth")
    np.testing.assert_array_equal(FeatureStore(str(tmp_path)).load("x"), f.float().numpy())


def _small_model_config():
    # 128 px -> 256 tokens a clip, compressible to the 64-token ToMe target
    from blim_tpu_torch.core.config import tiny_model_config

    cfg = tiny_model_config(image_size=128)
    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, hidden_size=128, num_attention_heads=2), mm_hidden_size=128)


def test_main_extracts_a_gif_and_a_frame_dir(tmp_path, monkeypatch, capsys):
    import blim_tpu_torch.core.config as core_config

    data_root = tmp_path / "data"
    vids = data_root / "MSRVTT" / "videos"
    os.makedirs(vids)
    _make_gif(str(vids / "a.gif"), 20)
    _make_frame_dir(str(vids / "b"), 9)
    cfg = _small_model_config()
    monkeypatch.setattr(core_config, "ModelConfig", lambda: cfg)
    args = tex.get_args_parser().parse_args([
        "--dataset", "MSRVTT", "--data_root", str(data_root),
        "--model_path", str(tmp_path / "nonexistent"), "--num_frames", "8",
        "--batch_size", "2", "--bench", "--pack", "--device", "cpu",
    ])
    tex.main(args)
    out = data_root / "MSRVTT" / "features"
    assert sorted(p.name for p in out.iterdir()) == [
        "a.npy", "b.npy", "features.idx.json", "features.pack"]
    a = np.load(out / "a.npy")
    assert a.shape == (8 // cfg.mm_local_num_frames, cfg.tokens_per_clip, 128)
    assert a.dtype == np.float16 and np.isfinite(a.astype(np.float32)).all()
    assert '"extract_videos_per_sec_e2e"' in capsys.readouterr().out
    np.testing.assert_array_equal(FeatureStore(str(out)).load("a"), a.astype(np.float32))


def test_main_refuses_a_checkpoint_it_cannot_read(tmp_path):
    (tmp_path / "ckpt").mkdir()
    (tmp_path / "ckpt" / "config.json").write_text("{}")
    args = tex.get_args_parser().parse_args([
        "--data_root", str(tmp_path), "--model_path", str(tmp_path / "ckpt"), "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no checkpoint shards"):
        tex.main(args)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tex.make_featurizer({"patch_embed": {"kernel": torch.zeros(1)}}, ModelConfig())
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tex.run_extraction([], None, None, None, batch_size=1, clips=1, local_frames=1)
