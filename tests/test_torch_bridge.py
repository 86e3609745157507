"""The weight bridge (JAX parameter tree <-> the port's tensors), the port's
seeded torch init, and the rule that a CUDA request without a GPU raises
instead of drifting to the CPU."""

import numpy as np
import pytest
import torch
import jax

from blim_tpu.core.config import tiny_model_config as jax_tiny_config
from blim_tpu.models import videochat_flash as jvcf

from blim_tpu_torch.checkpoints import convert
from blim_tpu_torch.core.config import tiny_model_config
from blim_tpu_torch.core.device import resolve_device
from blim_tpu_torch.data.prompts import make_vtg_layout
from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
from blim_tpu_torch.engine.rerank import RerankEngine

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def jax_params():
    params = jvcf.init_params(jax_tiny_config(vocab_size=152064), jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_round_trip_is_exact(jax_params):
    t = convert.params_from_numpy(jax_params, torch.float32, "cpu")
    back = _flat(convert.params_to_numpy(t))
    orig = _flat(jax_params)
    assert back.keys() == orig.keys()
    for k in orig:
        assert back[k].shape == orig[k].shape, k
        np.testing.assert_array_equal(back[k], orig[k], err_msg=k)


def test_layout_is_kept_stacked_in_out(jax_params):
    """(L, in, out) kernels and (L, D) norms: the bridge transposes nothing."""
    t = convert.params_from_numpy(jax_params, torch.float32, "cpu")
    cfg = tiny_model_config(vocab_size=152064)
    L, D = cfg.llm.num_hidden_layers, cfg.llm.hidden_size
    assert tuple(t["llm"]["layers"]["q_proj"]["kernel"].shape) == (
        L, D, cfg.llm.num_attention_heads * cfg.llm.head_dim)
    assert tuple(t["llm"]["layers"]["down_proj"]["kernel"].shape) == (
        L, cfg.llm.intermediate_size, D)
    assert tuple(t["llm"]["lm_head"]["kernel"].shape) == (D, cfg.llm.vocab_size)


def test_bf16_bridge_keeps_visual_head_fp32(jax_params):
    t = convert.params_from_numpy(jax_params, torch.bfloat16, "cpu")
    flat = _flat(t)
    for k, v in flat.items():
        want = torch.float32 if k.startswith("visual_head/") else torch.bfloat16
        assert v.dtype == want, k
    np.testing.assert_array_equal(
        flat["llm/embed_tokens/embedding"].float().numpy(),
        torch.tensor(jax_params["llm"]["embed_tokens"]["embedding"]).bfloat16().float().numpy())


def test_torch_init_has_the_jax_tree_shapes(jax_params):
    t = convert.init_params(tiny_model_config(vocab_size=152064), seed=0, device="cpu")
    tf, jf = _flat(t), _flat(jax_params)
    assert tf.keys() == jf.keys()
    for k in jf:
        assert tuple(tf[k].shape) == jf[k].shape, k


def test_torch_init_distributions_and_seed():
    cfg = tiny_model_config(vocab_size=4096)
    a = convert.init_params(cfg, seed=3, device="cpu")
    b = convert.init_params(cfg, seed=3, device="cpu")
    c = convert.init_params(cfg, seed=4, device="cpu")
    fa, fb, fc = _flat(a), _flat(b), _flat(c)
    for k in fa:
        torch.testing.assert_close(fa[k], fb[k], rtol=0, atol=0)
    emb = fa["llm/embed_tokens/embedding"]
    assert abs(emb.std().item() - 0.02) < 1e-3
    assert not torch.equal(emb, fc["llm/embed_tokens/embedding"])
    assert torch.count_nonzero(fa["llm/layers/q_proj/bias"]) == 0
    assert torch.equal(fa["llm/norm/scale"], torch.ones_like(fa["llm/norm/scale"]))
    fc1 = fa["projector/mlp/fc1/kernel"]
    assert abs(fc1.std().item() - (2.0 / sum(fc1.shape)) ** 0.5) < 0.1 * fc1.std().item()
    bf = convert.init_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu")
    assert bf["llm"]["layers"]["gate_proj"]["kernel"].dtype == torch.bfloat16
    assert bf["visual_head"]["kernel"].dtype == torch.float32


def test_cuda_without_gpu_raises(monkeypatch, jax_params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        convert.params_from_numpy(jax_params, torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        convert.init_params(tiny_model_config(), device="cuda")
    cfg = tiny_model_config(vocab_size=152064)
    params = convert.params_from_numpy(jax_params, torch.float32, "cpu")
    layout = make_vtg_layout(ByteFallbackTokenizer(), "MSRVTT", cfg.video_tokens_vtg, 24)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        RerankEngine(params, cfg, layout)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.fixture(scope="module")
def jax_trainable():
    from blim_tpu.engine import train as jtrain

    cfg = jax_tiny_config(vocab_size=152064)
    tree = jtrain.init_trainable(jax.random.key(1), cfg, jtrain.TrainConfig(),
                                 visual_head=jax.numpy.full((64, 32), 0.02))
    tree = jax.tree_util.tree_map(np.array, tree)
    rng = np.random.default_rng(0)
    for name, leaf in _flat(tree).items():
        leaf[...] = rng.standard_normal(leaf.shape).astype(np.float32)   # exact in fp32 only
    return tree


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_and_visual_head_stay_fp32_in_the_weight_bridge(jax_trainable, dtype):
    t = _flat(convert.params_from_numpy(jax_trainable, dtype, "cpu"))
    assert len(t) == 19
    for k, v in t.items():
        assert v.dtype == torch.float32, k


def test_trainable_round_trip_is_exact(jax_trainable):
    t = convert.trainable_from_numpy(jax_trainable, "cpu")
    flat = _flat(t)
    orig = _flat(jax_trainable)
    assert flat.keys() == orig.keys()
    for k, v in flat.items():
        assert v.dtype == torch.float32 and v.requires_grad and v.is_leaf, k
        assert tuple(v.shape) == orig[k].shape, k
    back = _flat(convert.params_to_numpy(t))
    for k in orig:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], orig[k], err_msg=k)
    grads = _flat(convert.grads_to_numpy(t))   # no backward yet: zeros of each shape
    for k in orig:
        assert grads[k].shape == orig[k].shape and not grads[k].any()
    back["visual_head/kernel"][0, 0] += 1.0   # a copy: the tensor keeps its value
    assert float(t["visual_head"]["kernel"].detach()[0, 0]) == orig["visual_head/kernel"][0, 0]
