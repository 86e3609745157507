"""The port's video chat and generate (blim_tpu_torch/models/videochat_flash)
against the JAX package's, on the CPU in fp32: a tiny Qwen2 (2 layers,
width 64, the 152k vocabulary the byte tokenizer's special ids need) with a
2-block tower, fed the same weights; a tiny video written with OpenCV; each
package's own featurizer, image processor and byte tokenizer. The chat's
text and history must be equal, turn by turn, and `generate`'s tokens with
and without an image slot must be equal. The LM head's columns past the 256
byte tokens are zeroed in the shared weights, so greedy decoding emits bytes
and the compared text is not empty."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blim_tpu.core.config import ModelConfig as JModelConfig
from blim_tpu.core.config import VisionConfig as JVisionConfig
from blim_tpu.core.config import tiny_model_config as jax_tiny_config
from blim_tpu.data.prompts import tokenizer_image_token as jax_tokenizer_image_token
from blim_tpu.data.tokenization import ByteFallbackTokenizer as JTokenizer
from blim_tpu.data.video import load_video as jax_load_video
from blim_tpu.models import umt_vit as jvit
from blim_tpu.models import videochat_flash as jvcf
from blim_tpu.pipelines import extract as jex

from blim_tpu_torch.checkpoints.convert import params_from_numpy
from blim_tpu_torch.core.config import ModelConfig, VisionConfig, tiny_model_config
from blim_tpu_torch.data.prompts import tokenizer_image_token
from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
from blim_tpu_torch.data.video import load_video
from blim_tpu_torch.kernels import flash_attention as tfa
from blim_tpu_torch.models import umt_vit as tvit
from blim_tpu_torch.models import videochat_flash as tvcf
from blim_tpu_torch.pipelines import extract as tex

torch.backends.cuda.matmul.allow_tf32 = False

VISION = dict(image_size=64, hidden_size=128, num_attention_heads=2, num_hidden_layers=3,
              return_idx=-2, num_frames=2)       # 2 blocks, 2 heads of 64, 32 tokens a clip
MODEL = dict(mm_hidden_size=128, mm_local_num_frames=2, num_clips=2, tokens_per_frame=2)
NEW_TOKENS = 12


def _config(vision_cls, model_cls, tiny):
    llm = tiny(vocab_size=152064).llm
    return model_cls(llm=llm, vision=vision_cls(**VISION), **MODEL)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The decode loop is thousands of tiny ops: one intra-op thread keeps
    them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import cv2

    jcfg = _config(JVisionConfig, JModelConfig, jax_tiny_config)
    tcfg = _config(VisionConfig, ModelConfig, tiny_model_config)
    jp = jvcf.init_params(jcfg, jax.random.key(0))
    jp["vision_tower"] = jvit.init_params(jcfg.vision, jax.random.key(1))
    rng = np.random.default_rng(11)
    npp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), jp)
    npp["llm"]["lm_head"]["kernel"][:, 256:] = 0.0
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    tp = params_from_numpy(npp, torch.float32, "cpu")

    # 8 s at 2 fps: 16 frames, sampled down to 8 (4 clips of 2 frames)
    path = str(tmp_path_factory.mktemp("video") / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 2.0, (80, 48))
    assert writer.isOpened()
    base = rng.integers(0, 256, (48, 96, 3), dtype=np.uint8)
    for t in range(16):
        writer.write(np.ascontiguousarray(base[:, t:t + 80]))
    writer.release()
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, path=path,
                jfeat=jex.make_featurizer(jp["vision_tower"], jcfg),
                tfeat=tex.make_featurizer(tp["vision_tower"], tcfg, device="cpu"),
                jproc=jvit.UMTImageProcessor((64, 64)), tproc=tvit.UMTImageProcessor((64, 64)))


def test_load_video_matches_jax(setup):
    for cap in (512, 4):
        frames, msg = load_video(setup["path"], max_num_frames=cap, local_num_frames=2)
        jframes, jmsg = jax_load_video(setup["path"], max_num_frames=cap, local_num_frames=2)
        np.testing.assert_array_equal(frames, jframes)
        assert msg == jmsg
        assert frames.shape == (min(cap, 8), 48, 80, 3)
    assert msg == "The video lasts for 8.00 seconds, and 4 frames are uniformly sampled from it."


def _chat_both(setup, prompt, jhist=None, thist=None):
    s = setup
    jtext, jh = jvcf.chat(s["jp"], s["jcfg"], s["path"], JTokenizer(), prompt, s["jfeat"],
                          s["jproc"], chat_history=jhist, max_new_tokens=NEW_TOKENS)
    tfa.reset_counts()
    ttext, th = tvcf.chat(s["tp"], s["tcfg"], s["path"], ByteFallbackTokenizer(), prompt,
                          s["tfeat"], s["tproc"], chat_history=thist, max_new_tokens=NEW_TOKENS,
                          device="cpu")
    assert not any(tfa.counts().values())
    return (jtext, jh), (ttext, th)


def test_chat_matches_jax_turn_by_turn(setup):
    (jtext, jh), (ttext, th) = _chat_both(setup, "What happens in the video?")
    assert ttext == jtext and ttext != ""
    assert th == jh and len(th) == 2
    assert th[0] == {"role": "<|im_start|>user", "content": "What happens in the video?"}
    (jtext2, jh2), (ttext2, th2) = _chat_both(setup, "And then?", jh, th)
    assert ttext2 == jtext2
    assert th2 == jh2 and len(th2) == 4 and th2[:2] == th


def test_chat_returns_text_alone(setup):
    s = setup
    text = tvcf.chat(s["tp"], s["tcfg"], s["path"], ByteFallbackTokenizer(), "Hi", s["tfeat"],
                     s["tproc"], return_history=False, max_new_tokens=4, device="cpu")
    assert isinstance(text, str)


@pytest.mark.parametrize("with_image", [True, False], ids=["image-slot", "text-only"])
def test_generate_matches_jax(setup, with_image):
    s = setup
    prompt = ("<|im_start|>user\n<image>\nDescribe it.<|im_end|>\n<|im_start|>assistant\n"
              if with_image else "<|im_start|>user\nSay hi.<|im_end|>\n<|im_start|>assistant\n")
    ids = tokenizer_image_token(prompt, ByteFallbackTokenizer())
    assert ids == jax_tokenizer_image_token(prompt, JTokenizer())
    assert (-200 in ids) == with_image
    video = np.random.default_rng(2).standard_normal((16, s["tcfg"].llm.hidden_size)).astype(
        np.float32)
    want = np.asarray(jvcf.generate(s["jp"], s["jcfg"], ids, jnp.asarray(video), JTokenizer(),
                                    max_new_tokens=NEW_TOKENS))
    got = tvcf.generate(s["tp"], s["tcfg"], ids, torch.from_numpy(video), ByteFallbackTokenizer(),
                        max_new_tokens=NEW_TOKENS, device="cpu")
    assert got.shape == (NEW_TOKENS,)
    np.testing.assert_array_equal(got, want)
    tokens, logits = tvcf.generate(s["tp"], s["tcfg"], ids, torch.from_numpy(video),
                                   ByteFallbackTokenizer(), max_new_tokens=NEW_TOKENS,
                                   device="cpu", return_logits=True)
    np.testing.assert_array_equal(tokens, want)
    assert logits.shape == (NEW_TOKENS, s["tcfg"].llm.vocab_size)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), want)


def test_chat_and_generate_default_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    s = setup
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tvcf.generate(s["tp"], s["tcfg"], [1, 2, 3], torch.zeros(0, 64), ByteFallbackTokenizer())
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tvcf.chat(s["tp"], s["tcfg"], s["path"], ByteFallbackTokenizer(), "Hi", s["tfeat"],
                  s["tproc"])


def test_tiny_config_matches_between_packages(setup):
    assert dataclasses.asdict(setup["tcfg"]) == dataclasses.asdict(setup["jcfg"])
