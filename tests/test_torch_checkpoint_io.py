"""The port's checkpoint IO against the `safetensors` package and the JAX
package, on the CPU at the tiny config.

  * the port's safetensors reader reads files the `safetensors` package
    wrote, bit for bit (F32, F16, BF16 and the integer and bool types,
    single-file and sharded with an index), and the package reads the
    port writer's files back;
  * on a synthetic HF state dict with the vision tower, both projector
    MLPs and visual_head, the port's converter and `load_hf_state_dict`
    equal the JAX package's exactly (a tied or missing lm_head included),
    and `export_hf_state_dict` inverts the converter;
  * the streaming `load_videochat_flash` equals `params_from_numpy` of the
    converted tree, from safetensors shards and from pytorch_model.bin, in
    fp32 and bf16;
  * `state_io` round-trips the trainable tree, the AdamW state, the epoch
    and the args, refuses a parameter-count mismatch, and a train step
    taken after resuming equals the step taken without the interruption.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from blim_tpu.checkpoints import convert as jconvert
from blim_tpu.core.config import tiny_model_config as jax_tiny_config

from blim_tpu_torch.checkpoints import convert, safetensors_io, state_io
from blim_tpu_torch.core.config import tiny_model_config
from blim_tpu_torch.data.collate import collate_train_batch
from blim_tpu_torch.data.prompts import make_tvg_layout, make_vtg_layout
from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
from blim_tpu_torch.engine import train as ttrain

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32, torch.uint8,
          torch.bool]


def _package():
    """safetensors.torch, the yardstick (skips where it is not installed)."""
    return pytest.importorskip("safetensors.torch")


def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = {"a.weight": (5, 7), "b": (3,), "c.scalar": (), "d.empty": (0, 4), "e": (2, 3, 4)}
    out = {}
    for name, shape in shapes.items():
        x = torch.randn(shape, generator=g) * 50
        if dtype == torch.bool:
            out[name] = x > 0
        elif dtype.is_floating_point:
            out[name] = x.to(dtype)
        else:
            out[name] = x.abs().to(dtype)
    return out


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("dtype", DTYPES, ids=[str(d).split(".")[1] for d in DTYPES])
def test_reader_reads_the_packages_files_bit_for_bit(tmp_path, dtype):
    want = _tensors(dtype)
    _package().save_file(want, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    f = safetensors_io.SafetensorsFile(str(tmp_path / "x.safetensors"))
    assert sorted(f.keys()) == sorted(want) and f.metadata == {"format": "pt"}
    for name, t in want.items():
        assert _same_bits(f.get(name), t), name


def test_reader_reads_a_mixed_dtype_file_bit_for_bit(tmp_path):
    want = {f"{i}.{k}": v for i, d in enumerate(DTYPES) for k, v in _tensors(d, i).items()}
    _package().save_file(want, str(tmp_path / "mixed.safetensors"))
    got = safetensors_io.load_file(str(tmp_path / "mixed.safetensors"))
    assert got.keys() == want.keys()
    for name in want:
        assert _same_bits(got[name], want[name]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["F32", "F16", "BF16"])
def test_reader_reads_a_sharded_checkpoint_through_its_index(tmp_path, dtype):
    g = torch.Generator().manual_seed(1)
    want = {f"layers.{i}.w": torch.randn(16, 8, generator=g).to(dtype) for i in range(5)}
    weight_map = {}
    for s, names in enumerate((["layers.0.w", "layers.3.w"], ["layers.1.w"],
                               ["layers.2.w", "layers.4.w"])):
        file = safetensors_io.shard_name(s, 3)
        _package().save_file({k: want[k] for k in names}, str(tmp_path / file))
        weight_map.update(dict.fromkeys(names, file))
    (tmp_path / safetensors_io.INDEX_FILE).write_text(json.dumps({"weight_map": weight_map}))
    files = safetensors_io.checkpoint_files(str(tmp_path))
    assert len(files) == 3
    seen = {}
    for path, names in files.items():
        f = safetensors_io.SafetensorsFile(path)
        seen.update({k: f.get(k) for k in names})
    assert seen.keys() == want.keys()
    for k in want:
        assert _same_bits(seen[k], want[k]), k


@pytest.mark.parametrize("dtype", DTYPES, ids=[str(d).split(".")[1] for d in DTYPES])
def test_package_reads_the_writers_files(tmp_path, dtype):
    want = _tensors(dtype, 3)
    # a non-contiguous view is written as its values
    want["t.view"] = want["a.weight"].t()
    safetensors_io.save_file(want, str(tmp_path / "y.safetensors"), metadata={"k": "v"})
    got = _package().load_file(str(tmp_path / "y.safetensors"))
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert _same_bits(got[name], t.contiguous()), name


def test_package_reads_the_writers_shards(tmp_path):
    g = torch.Generator().manual_seed(2)
    want = {f"m.{i}": torch.randn(64, 32, generator=g).to(torch.bfloat16) for i in range(6)}
    want["head"] = torch.randn(32, generator=g)              # F32 beside BF16
    weight_map = safetensors_io.save_sharded(want, str(tmp_path), max_shard_bytes=3 * 64 * 32 * 2)
    index = json.loads((tmp_path / safetensors_io.INDEX_FILE).read_text())
    assert index["weight_map"] == weight_map
    assert len(set(weight_map.values())) == 3
    got = {}
    for file in sorted(set(weight_map.values())):
        got.update(_package().load_file(str(tmp_path / file)))
    assert got.keys() == want.keys()
    for k in want:
        assert _same_bits(got[k], want[k]), k


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------

def hf_state_dict(cfg, dtype=torch.float32, seed=0, tower=True, lm_head=True):
    """A synthetic VideoChat-Flash state dict with the published key names."""
    g = torch.Generator().manual_seed(seed)
    L, D, I = cfg.llm.num_hidden_layers, cfg.llm.hidden_size, cfg.llm.intermediate_size
    H, K, hd = cfg.llm.num_attention_heads, cfg.llm.num_key_value_heads, cfg.llm.head_dim
    mm, vd, VL = cfg.mm_hidden_size, cfg.vision.hidden_size, cfg.vision.depth
    vi = int(vd * cfg.vision.mlp_ratio)
    ps, tub = cfg.vision.patch_size, cfg.vision.tubelet_size

    def t(*shape):
        return (torch.randn(shape, generator=g) * 0.05).to(dtype)

    sd = {"model.embed_tokens.weight": t(cfg.llm.vocab_size, D), "model.norm.weight": t(D),
          "visual_head.weight": t(mm, D)}
    if lm_head:
        sd["lm_head.weight"] = t(cfg.llm.vocab_size, D)
    for i in range(L):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = t(D)
        sd[p + "post_attention_layernorm.weight"] = t(D)
        sd[p + "self_attn.q_proj.weight"] = t(H * hd, D)
        sd[p + "self_attn.q_proj.bias"] = t(H * hd)
        sd[p + "self_attn.k_proj.weight"] = t(K * hd, D)
        sd[p + "self_attn.k_proj.bias"] = t(K * hd)
        sd[p + "self_attn.v_proj.weight"] = t(K * hd, D)
        sd[p + "self_attn.v_proj.bias"] = t(K * hd)
        sd[p + "self_attn.o_proj.weight"] = t(D, H * hd)
        sd[p + "mlp.gate_proj.weight"] = t(I, D)
        sd[p + "mlp.up_proj.weight"] = t(I, D)
        sd[p + "mlp.down_proj.weight"] = t(D, I)
    for name in ("mlp", "tvg_mlp"):
        sd[f"model.mm_projector.{name}.0.weight"] = t(D, mm)
        sd[f"model.mm_projector.{name}.0.bias"] = t(D)
        sd[f"model.mm_projector.{name}.2.weight"] = t(D, D)
        sd[f"model.mm_projector.{name}.2.bias"] = t(D)
    if tower:
        vt = "model.vision_tower.vision_tower.encoder."
        sd[vt + "patch_embed.proj.weight"] = t(vd, 3, tub, ps, ps)
        sd[vt + "patch_embed.proj.bias"] = t(vd)
        sd[vt + "vision_layernorm.weight"] = t(vd)
        sd[vt + "vision_layernorm.bias"] = t(vd)
        for i in range(VL):
            b = vt + f"blocks.{i}."
            for n in ("norm1", "norm2"):
                sd[b + n + ".weight"] = t(vd)
                sd[b + n + ".bias"] = t(vd)
            sd[b + "attn.qkv.weight"] = t(3 * vd, vd)
            sd[b + "attn.q_bias"] = t(vd)
            sd[b + "attn.v_bias"] = t(vd)
            sd[b + "attn.proj.weight"] = t(vd, vd)
            sd[b + "attn.proj.bias"] = t(vd)
            sd[b + "mlp.fc1.weight"] = t(vi, vd)
            sd[b + "mlp.fc1.bias"] = t(vi)
            sd[b + "mlp.fc2.weight"] = t(vd, vi)
            sd[b + "mlp.fc2.bias"] = t(vd)
    return sd


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
            continue
        g = got[k].float().numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = want[k].float().numpy() if isinstance(want[k], torch.Tensor) else want[k]
        assert g.shape == w.shape, k
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


CASES = {"tower+lm_head": dict(), "tied": dict(tie=True), "no-lm_head": dict(lm_head=False),
         "no-tower": dict(tower=False)}


def _cfgs(tie=False):
    j, t = jax_tiny_config(), tiny_model_config()
    if tie:
        j = dataclasses.replace(j, llm=dataclasses.replace(j.llm, tie_word_embeddings=True))
        t = dataclasses.replace(t, llm=dataclasses.replace(t.llm, tie_word_embeddings=True))
    return j, t


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_convert_videochat_flash_equals_jax(case, dtype):
    kw = dict(CASES[case])
    jcfg, tcfg = _cfgs(kw.pop("tie", False))
    sd = hf_state_dict(tcfg, dtype, **kw)
    got = convert.convert_videochat_flash(sd, tcfg)
    assert_trees_equal(got, jconvert.convert_videochat_flash(sd, jcfg))
    assert ("vision_tower" in got) == kw.get("tower", True)
    assert (got["llm"]["lm_head"]["kernel"] is None) == (case in ("tied", "no-lm_head"))


def test_required_keys_raise_like_jax():
    cfg = tiny_model_config()
    for key in ("visual_head.weight", "model.mm_projector.tvg_mlp.2.bias"):
        sd = hf_state_dict(cfg)
        del sd[key]
        for conv in (convert.convert_videochat_flash, jconvert.convert_videochat_flash):
            with pytest.raises(KeyError):
                conv(sd, cfg)


def test_export_inverts_the_converter():
    cfg = tiny_model_config()
    sd = hf_state_dict(cfg, seed=4)
    tree = convert.params_from_numpy(convert.convert_videochat_flash(sd, cfg), device="cpu")
    tree["vision_tower"] = convert.params_from_numpy(
        convert.convert_vision_tower(sd, cfg.vision), device="cpu")
    out = convert.export_hf_state_dict(tree)
    assert out.keys() == sd.keys()
    for k in sd:
        assert torch.equal(out[k], sd[k]), k


def _write_checkpoint(path, sd, kind):
    path.mkdir()
    if kind == "bin":
        torch.save(sd, str(path / "pytorch_model.bin"))
    elif kind == "single":   # written by the yardstick package
        _package().save_file(sd, str(path / "model.safetensors"))
    else:   # sharded through the port's writer, with an index
        safetensors_io.save_sharded(sd, str(path), max_shard_bytes=200_000)
        assert len(list(path.glob("model-*-of-*.safetensors"))) > 1


@pytest.mark.parametrize("kind", ["single", "sharded", "bin"])
def test_load_hf_state_dict_equals_jax(tmp_path, kind):
    cfg = tiny_model_config()
    sd = hf_state_dict(cfg, torch.bfloat16 if kind != "bin" else torch.float32, seed=5)
    _write_checkpoint(tmp_path / "ckpt", sd, kind)
    got = convert.load_hf_state_dict(str(tmp_path / "ckpt"))
    want = jconvert.load_hf_state_dict(str(tmp_path / "ckpt"))
    assert got.keys() == want.keys() == sd.keys()
    for k in sd:
        assert _same_bits(got[k], sd[k]), k
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(want[k], np.float32))


def test_load_hf_state_dict_without_shards_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        convert.load_hf_state_dict(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        convert.load_videochat_flash(str(tmp_path), tiny_model_config(), device="cpu")


@pytest.mark.parametrize("kind", ["single", "sharded", "bin"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_streaming_loader_equals_converted_tree(tmp_path, kind, dtype):
    cfg = tiny_model_config()
    sd = hf_state_dict(cfg, torch.bfloat16 if kind == "sharded" else torch.float32, seed=6)
    _write_checkpoint(tmp_path / "ckpt", sd, kind)
    got = convert.load_videochat_flash(str(tmp_path / "ckpt"), cfg, dtype=dtype, device="cpu")
    want = convert.params_from_numpy(
        convert.convert_videochat_flash(convert.load_hf_state_dict(str(tmp_path / "ckpt")), cfg),
        dtype, "cpu")
    assert got["visual_head"]["kernel"].dtype == torch.float32
    assert got["llm"]["layers"]["q_proj"]["kernel"].dtype == dtype
    for k, t in flat(got).items():
        assert t.is_contiguous(), k
    assert_trees_equal(got, want)
    tower = convert.load_videochat_flash(str(tmp_path / "ckpt"), cfg, dtype=dtype, device="cpu",
                                         parts=("vision_tower",))
    assert list(tower) == ["vision_tower"]
    assert_trees_equal(tower["vision_tower"], want["vision_tower"])


def test_streaming_loader_ties_and_requires_like_the_converter(tmp_path):
    _, cfg = _cfgs(tie=True)
    sd = hf_state_dict(cfg, seed=7, tower=False)
    _write_checkpoint(tmp_path / "tied", sd, "sharded")
    got = convert.load_videochat_flash(str(tmp_path / "tied"), cfg, dtype=torch.float32,
                                       device="cpu")
    assert got["llm"]["lm_head"]["kernel"] is None and "vision_tower" not in got
    del sd["visual_head.weight"]
    _write_checkpoint(tmp_path / "no_head", sd, "sharded")
    with pytest.raises(KeyError):
        convert.load_videochat_flash(str(tmp_path / "no_head"), cfg, device="cpu")


# ---------------------------------------------------------------------------
# trainable-state save / resume
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_setup():
    cfg = tiny_model_config(vocab_size=152064, num_clips=4)
    frozen = convert.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tok = ByteFallbackTokenizer()
    vtg = make_vtg_layout(tok, "MSRVTT", cfg.video_tokens_vtg, max_caption_tokens=32)
    tvg = make_tvg_layout(tok, cfg.num_clips, max_caption_tokens=32)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal(
        (4, cfg.num_clips, cfg.tokens_per_clip, cfg.mm_hidden_size)).astype(np.float32) * 0.5
    batches = [collate_train_batch(caps, feats, np.arange(4), tok, "MSRVTT", vtg, tvg)
               for caps in (["a cat sits", "a man runs", "kids play ball", "a chef cooks"],
                            ["dogs bark", "rain falls", "a car turns", "two friends talk"])]
    tcfg = ttrain.TrainConfig(lr=1e-3, warmup_epochs=0.0, epochs=2,
                              lora=ttrain.lora_lib.LoraConfig(dropout=0.0))
    return dict(cfg=cfg, frozen=frozen, vtg=vtg, tvg=tvg, batches=batches,
                vocab=torch.from_numpy(feats.mean(axis=-2)), tcfg=tcfg)


def _fresh_state(s, seed):
    trainable = ttrain.init_trainable(
        torch.Generator().manual_seed(seed), s["cfg"], s["tcfg"],
        visual_head=torch.full((s["cfg"].llm.hidden_size, s["cfg"].mm_hidden_size), 0.02))
    return ttrain.init_train_state(trainable, s["tcfg"], steps_per_epoch=2)


def test_state_round_trips(tmp_path, train_setup):
    s = train_setup
    state = _fresh_state(s, 0)
    step = ttrain.make_train_step(s["cfg"], s["tcfg"], s["vtg"], s["tvg"], device="cpu")
    state, _ = step(state, s["frozen"], s["batches"][0], s["vocab"])
    args = {"lr": 1e-3, "dataset": "MSRVTT", "alpha": [0.0, 0.9]}
    path = state_io.save_checkpoint(str(tmp_path), "epoch0", state.trainable, state.optimizer,
                                    epoch=3, args=args)
    meta = json.loads((tmp_path / "epoch0" / "meta.json").read_text())
    assert meta == {"epoch": 3, "n_trainable": state_io.count_params(state.trainable),
                    "args": args}
    trainable, opt, epoch = state_io.load_checkpoint(path, state.trainable)
    assert epoch == 3
    got, want = flat(trainable), flat(state.trainable)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k].detach()), k
    ref = state.optimizer.state_dict()
    assert opt["param_groups"] == ref["param_groups"]
    assert opt["state"].keys() == ref["state"].keys()
    for i, entry in ref["state"].items():
        for name, v in entry.items():
            assert torch.equal(opt["state"][i][name], v), (i, name)


def test_resume_refuses_a_count_mismatch(tmp_path, train_setup):
    state = _fresh_state(train_setup, 0)
    path = state_io.save_checkpoint(str(tmp_path), "best", state.trainable, None, epoch=0)
    bad = dict(state.trainable, visual_head={"kernel": torch.zeros(2, 2)})
    with pytest.raises(AssertionError, match="trainable param count mismatch"):
        state_io.load_checkpoint(path, bad)
    _, opt, _ = state_io.load_checkpoint(path)
    assert opt is None


def test_step_after_resume_equals_the_uninterrupted_step(tmp_path, train_setup):
    s = train_setup
    step = ttrain.make_train_step(s["cfg"], s["tcfg"], s["vtg"], s["tvg"], device="cpu")
    straight = _fresh_state(s, 0)
    for b in s["batches"]:
        straight, m_straight = step(straight, s["frozen"], b, s["vocab"])

    first = _fresh_state(s, 0)
    first, _ = step(first, s["frozen"], s["batches"][0], s["vocab"])
    path = state_io.save_checkpoint(str(tmp_path), "epoch0", first.trainable, first.optimizer, 0)
    resumed = _fresh_state(s, 9)          # other initial values, overwritten by the resume
    trainable, opt, _ = state_io.load_checkpoint(path, resumed.trainable)
    state_io.assign_trainable(resumed.trainable, trainable)
    resumed.optimizer.load_state_dict(opt)
    resumed.step = resumed.applied = 1
    resumed, m_resumed = step(resumed, s["frozen"], s["batches"][1], s["vocab"])
    assert float(m_resumed["loss"]) == float(m_straight["loss"])
    for k, t in flat(straight.trainable).items():
        assert torch.equal(flat(resumed.trainable)[k], t), k
