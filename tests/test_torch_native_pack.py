"""The port's native feature-pack reader (blim_tpu_torch/data/native_pack.py,
its copy of feature_pack.cpp) against the JAX package's and against the
numpy memmap: the library builds into the port's ignored _build/, gathers
are bit for bit the same as both, a negative or out-of-range index gives
zeros, fp16 edge values convert exactly, and FeatureStore reads through it
(`reader == "native"`), or through the memmap when it cannot be built."""

from pathlib import Path

import numpy as np
import pytest

from blim_tpu.data.features import FeatureStore as JFeatureStore
from blim_tpu.data.native_pack import NativePack as JNativePack

from blim_tpu_torch.data import native_pack
from blim_tpu_torch.data.features import FeatureStore
from blim_tpu_torch.data.native_pack import NativePack

REPO = Path(__file__).resolve().parents[1]
SHAPE = (4, 8, 16)
N = 9


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    root = tmp_path_factory.mktemp("pack")
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((N, *SHAPE)).astype(np.float32)
    vids = [f"v{i}" for i in range(N)]
    FeatureStore.write_pack(str(root), vids, feats, dtype="float16")
    return root, vids, feats


def _memmap(root, dtype=np.float16, n=N):
    return np.memmap(root / "features.pack", dtype=dtype, mode="r", shape=(n, *SHAPE))


def test_library_builds_into_the_ports_build_dir():
    assert native_pack.load_library() is not None, "g++ build of feature_pack.cpp failed"
    so = native_pack.library_path()
    assert so.exists()
    assert so.parent.parent == REPO / "blim_tpu_torch" / "_build"
    assert so.parent.name.startswith("feature_pack-")
    assert native_pack.SOURCE == REPO / "blim_tpu_torch" / "data" / "csrc" / "feature_pack.cpp"


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("order", [[3, 0, 4], [8, 8, 1, 0, 5, 2, 7], list(range(N))[::-1]],
                         ids=["three", "repeats", "all-reversed"])
def test_gather_equals_jax_and_the_memmap_bit_for_bit(pack, threads, order):
    root, _, feats = pack
    idx = np.asarray(order, np.int64)
    t = NativePack(str(root / "features.pack"), N, SHAPE, "float16")
    j = JNativePack(str(root / "features.pack"), N, SHAPE, "float16")
    got = t.gather(idx, n_threads=threads)
    assert got.dtype == np.float32 and got.shape == (len(idx), *SHAPE)
    np.testing.assert_array_equal(got.view(np.uint32), j.gather(idx, n_threads=threads).view(np.uint32))
    np.testing.assert_array_equal(got, np.asarray(_memmap(root)[idx], np.float32))
    np.testing.assert_array_equal(got, feats[idx].astype(np.float16).astype(np.float32))
    t.close()
    j.close()


def test_fp32_pack_gathers_exactly(tmp_path):
    feats = np.random.default_rng(1).standard_normal((3, *SHAPE)).astype(np.float32)
    FeatureStore.write_pack(str(tmp_path), ["a", "b", "c"], feats, dtype="float32")
    t = NativePack(str(tmp_path / "features.pack"), 3, SHAPE, "float32")
    np.testing.assert_array_equal(t.gather(np.asarray([2, 0])), feats[[2, 0]])
    t.close()


def test_negative_or_out_of_range_index_gives_zeros(pack):
    root, _, _ = pack
    t = NativePack(str(root / "features.pack"), N, SHAPE, "float16")
    j = JNativePack(str(root / "features.pack"), N, SHAPE, "float16")
    idx = np.asarray([-1, 2, N, -7], np.int64)
    out = t.gather(idx)
    assert (out[[0, 2, 3]] == 0).all() and not (out[1] == 0).all()
    np.testing.assert_array_equal(out, j.gather(idx))
    t.close()
    j.close()


def test_fp16_conversion_edge_values(tmp_path):
    # subnormals, inf, nan, negative zero, the largest half, round-trip values
    vals = np.asarray(
        [0.0, -0.0, 1.0, -2.5, 6.1e-5, 5.96e-8, 65504.0, np.inf, -np.inf, np.nan,
         1e-7, 3.14159, -1e-6, 0.333251953125, 2.0, -65504.0], np.float32,
    ).reshape(1, 1, 16).repeat(4, 0).repeat(8, 1)
    FeatureStore.write_pack(str(tmp_path), ["x"], vals[None], dtype="float16")
    t = NativePack(str(tmp_path / "features.pack"), 1, SHAPE, "float16")
    j = JNativePack(str(tmp_path / "features.pack"), 1, SHAPE, "float16")
    out = t.gather(np.asarray([0], np.int64))[0]
    expect = vals.astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(out.view(np.uint32), expect.view(np.uint32))
    np.testing.assert_array_equal(out.view(np.uint32),
                                  j.gather(np.asarray([0], np.int64))[0].view(np.uint32))
    t.close()
    j.close()


def test_open_refuses_a_short_file(tmp_path):
    (tmp_path / "features.pack").write_bytes(b"\0" * 100)
    with pytest.raises(RuntimeError, match="failed to open"):
        NativePack(str(tmp_path / "features.pack"), 2, SHAPE, "float16")


def test_load_many_reads_native(pack):
    root, vids, feats = pack
    store = FeatureStore(str(root), shape=SHAPE)
    assert store.reader == "native"
    pick = ["v5", "v1", "v5", "v8"]
    got = store.load_many(pick)
    np.testing.assert_array_equal(got, JFeatureStore(str(root), shape=SHAPE).load_many(pick))
    idx = [int(v[1:]) for v in pick]
    np.testing.assert_array_equal(got, np.asarray(_memmap(root)[idx], np.float32))
    # a video outside the pack reads as zeros, through the per-video path
    mixed = store.load_many(["v2", "missing"])
    np.testing.assert_array_equal(mixed[0], feats[2].astype(np.float16).astype(np.float32))
    assert (mixed[1] == 0).all()


def test_load_many_falls_back_to_the_memmap_without_the_library(pack, monkeypatch):
    root, vids, _ = pack
    monkeypatch.setattr(native_pack, "load_library", lambda: None)
    store = FeatureStore(str(root), shape=SHAPE)
    assert store.reader == "memmap"
    monkeypatch.undo()
    native = FeatureStore(str(root), shape=SHAPE)
    assert native.reader == "native"
    np.testing.assert_array_equal(store.load_many(vids), native.load_many(vids))


def test_store_without_a_pack_has_no_reader(tmp_path):
    assert FeatureStore(str(tmp_path)).reader is None
