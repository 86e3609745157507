"""The port's LoRA train step against the JAX package's, on the CPU in fp32.

Tiny config (`tiny_model_config(vocab_size=152064, num_clips=4)`, as
tests/test_train_step.py), the JAX package's weights bridged to the port,
the same collated batch. The trainable tree is the JAX `init_trainable`
with LoRA B made non-zero (seeded noise): at init B = 0, so every gradient
of A is exactly 0 and a parity test on it would prove nothing. LoRA dropout
is 0 on both sides for the parity tests (JAX bits cannot be matched);
dropout is checked statistically instead.

Tolerances: fp32 sums in another order through two layers and a 152k-way
CE. Losses atol 1e-5 / rtol 1e-4; gradients 1e-4 x max|g| per leaf;
parameters after AdamW updates atol 2e-5 + rtol 1e-4 (Adam divides by
sqrt(nu): a gradient element near eps amplifies its rounding, bounded by
lr per step); grad_norm rtol 1e-4.
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blim_tpu.adapters import lora as jlora
from blim_tpu.core.config import tiny_model_config as jax_tiny_config
from blim_tpu.data.collate import collate_train_batch as jax_collate
from blim_tpu.data.prompts import make_tvg_layout as jax_tvg_layout
from blim_tpu.data.prompts import make_vtg_layout as jax_vtg_layout
from blim_tpu.engine import train as jtrain
from blim_tpu.models import projector as jprojector
from blim_tpu.models import qwen2 as jqwen2
from blim_tpu.models import videochat_flash as jvcf
from blim_tpu.scoring import criteria as jcriteria

from blim_tpu_torch.adapters import lora as tlora
from blim_tpu_torch.checkpoints import convert
from blim_tpu_torch.core.config import tiny_model_config
from blim_tpu_torch.data.datasets import RetrievalDataset, TrainLoader
from blim_tpu_torch.data.prompts import make_tvg_layout, make_vtg_layout
from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
from blim_tpu_torch.engine import loop as tloop
from blim_tpu_torch.engine import train as ttrain
from blim_tpu_torch.kernels import flash_attention as tfa
from blim_tpu_torch.models import projector as tprojector
from blim_tpu_torch.models import qwen2 as tqwen2
from blim_tpu_torch.models import videochat_flash as tvcf
from blim_tpu_torch.scoring import criteria as tcriteria

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LOSS_ATOL, LOSS_RTOL = 1e-5, 1e-4
GRAD_REL = 1e-4
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4
B, NVID = 4, 4
CAPTIONS = ["a cat sits", "a man runs", "kids play ball", "a chef cooks"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)   # writable copies


@pytest.fixture(scope="module")
def setup(tokenizer):
    jcfg = jax_tiny_config(vocab_size=152064, num_clips=4)
    tcfg = tiny_model_config(vocab_size=152064, num_clips=4)
    jp = jvcf.init_params(jcfg, jax.random.key(0))
    frozen_np = _np(jp)
    vtg_j = jax_vtg_layout(tokenizer, "MSRVTT", jcfg.video_tokens_vtg, max_caption_tokens=32)
    tvg_j = jax_tvg_layout(tokenizer, jcfg.num_clips, max_caption_tokens=32)
    ttok = ByteFallbackTokenizer()
    vtg_t = make_vtg_layout(ttok, "MSRVTT", tcfg.video_tokens_vtg, max_caption_tokens=32)
    tvg_t = make_tvg_layout(ttok, tcfg.num_clips, max_caption_tokens=32)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal(
        (NVID, jcfg.num_clips, jcfg.tokens_per_clip, jcfg.mm_hidden_size)).astype(np.float32) * 0.5
    batch = jax_collate(CAPTIONS, feats, np.arange(B), tokenizer, "MSRVTT", vtg_j, tvg_j)
    vocab = feats.mean(axis=-2)
    jtcfg = jtrain.TrainConfig(lora=jlora.LoraConfig(dropout=0.0))
    trainable = _np(jtrain.init_trainable(
        jax.random.key(2), jcfg, jtcfg,
        visual_head=jnp.zeros((jcfg.llm.hidden_size, jcfg.mm_hidden_size)) + 0.02))
    noise = np.random.default_rng(3)
    flat = _flat(trainable)
    for name, leaf in flat.items():   # make B non-zero, so A gets a gradient
        if name.endswith("/b"):
            leaf[...] = noise.standard_normal(leaf.shape).astype(np.float32) * 0.05
    trainable["visual_head"]["kernel"] = (
        noise.standard_normal(trainable["visual_head"]["kernel"].shape).astype(np.float32) * 0.05)
    return dict(jcfg=jcfg, tcfg=tcfg, frozen_np=frozen_np, batch=batch, vocab=vocab,
                trainable=trainable, vtg_j=vtg_j, tvg_j=tvg_j, vtg_t=vtg_t, tvg_t=tvg_t,
                feats=feats)


def _torch_frozen(setup):
    return convert.params_from_numpy(setup["frozen_np"], torch.float32, "cpu")


def _geoms(vtg, tvg):
    ws, wl = vtg.label_window
    return (vtg.video_start, ws, wl), (tvg.video_start, int(tvg.gather_positions[0]))


@pytest.fixture(scope="module")
def loss_and_grads(setup):
    jb = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    jvg, jtg = _geoms(setup["vtg_j"], setup["tvg_j"])
    (jloss, jm), jgrads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, setup["trainable"]), _jax_tree(setup["frozen_np"]),
        setup["jcfg"], jb, jnp.asarray(setup["vocab"]), jvg, jtg, 4.0, None, 0.0)
    trainable = convert.trainable_from_numpy(setup["trainable"], "cpu")
    tb = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    tvg_geom, ttg_geom = _geoms(setup["vtg_t"], setup["tvg_t"])
    tfa.reset_counts()
    loss, tm = ttrain.loss_fn(trainable, _torch_frozen(setup), setup["tcfg"], tb,
                              torch.from_numpy(setup["vocab"]), tvg_geom, ttg_geom, 4.0)
    loss.backward()
    counts = tfa.counts()
    return dict(jax={k: float(v) for k, v in jm.items()}, jgrads=_flat(_np(jgrads)),
                torch={k: float(v.detach()) for k, v in tm.items()},
                tgrads=_flat(convert.grads_to_numpy(trainable)), counts=counts)


def _jax_tree(frozen_np):
    return jax.tree_util.tree_map(jnp.asarray, frozen_np)


@pytest.mark.parametrize("name", ["loss", "vtg_loss", "tvg_loss"])
def test_loss_matches_jax(loss_and_grads, name):
    got, want = loss_and_grads["torch"][name], loss_and_grads["jax"][name]
    assert math.isfinite(got)
    assert got == pytest.approx(want, abs=LOSS_ATOL, rel=LOSS_RTOL)


LEAVES = ["lora/llm/layers/q_proj/a", "lora/llm/layers/q_proj/b",
          "lora/llm/layers/k_proj/a", "lora/llm/layers/k_proj/b",
          "lora/llm/layers/v_proj/a", "lora/llm/layers/v_proj/b",
          "lora/llm/layers/o_proj/a", "lora/llm/layers/o_proj/b",
          "lora/llm/lm_head/a", "lora/llm/lm_head/b",
          "lora/projector/mlp/fc1/a", "lora/projector/mlp/fc1/b",
          "lora/projector/mlp/fc2/a", "lora/projector/mlp/fc2/b",
          "lora/projector/tvg_mlp/fc1/a", "lora/projector/tvg_mlp/fc1/b",
          "lora/projector/tvg_mlp/fc2/a", "lora/projector/tvg_mlp/fc2/b",
          "visual_head/kernel"]


def test_every_trainable_leaf_is_checked(loss_and_grads):
    assert sorted(loss_and_grads["jgrads"]) == sorted(LEAVES)
    assert sorted(loss_and_grads["tgrads"]) == sorted(LEAVES)


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradient_matches_jax(loss_and_grads, leaf):
    got, want = loss_and_grads["tgrads"][leaf], loss_and_grads["jgrads"][leaf]
    assert got.shape == want.shape
    assert np.abs(want).max() > 0, "a zero reference gradient proves nothing"
    np.testing.assert_allclose(got, want, atol=GRAD_REL * np.abs(want).max(), rtol=0)


def test_cpu_train_forward_launches_no_kernel(loss_and_grads):
    assert loss_and_grads["counts"] == {"flash_fwd": 0, "flash_fwd_lse": 0, "flash_fwd_dense": 0,
                                        "flash_fwd_dense_lse": 0, "flash_dq": 0, "flash_dkv": 0,
                                        "flash_bwd_dense": 0, "flash_bwd_dense_prep": 0,
                                        "flash_bwd_dense_convert": 0}


# ---------------------------------------------------------------------------
# full steps: AdamW + schedule + accumulation against optax
# ---------------------------------------------------------------------------

def _train_cfgs(wd, accum=1, warmup=0.5):
    kw = dict(lr=1e-3, warmup_epochs=warmup, epochs=3, weight_decay=wd, accum_iter=accum)
    return (jtrain.TrainConfig(lora=jlora.LoraConfig(dropout=0.0), **kw),
            ttrain.TrainConfig(lora=tlora.LoraConfig(dropout=0.0), **kw))


SPE = 4  # steps per epoch: lr 0 at step 0 (warmup), then rising, then cosine


def _jax_run(setup, wd, n, accum=1, warmup=0.5):
    jtc, _ = _train_cfgs(wd, accum, warmup)
    tx = jtrain.make_optimizer(jtc, steps_per_epoch=SPE)
    trainable = jax.tree_util.tree_map(jnp.asarray, setup["trainable"])
    state = jtrain.TrainState(jnp.asarray(0), trainable, tx.init(trainable))
    step = jtrain.make_train_step(setup["jcfg"], jtc, tx, setup["vtg_j"], setup["tvg_j"])
    jb = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    frozen = _jax_tree(setup["frozen_np"])
    out = []
    for i in range(n):
        state, m = step(state, frozen, jb, jnp.asarray(setup["vocab"]), jax.random.key(i))
        out.append((_flat(_np(state.trainable)), float(m["grad_norm"]), float(m["loss"])))
    return out


def _torch_run(setup, wd, n, accum=1, frozen=None, warmup=0.5):
    _, ttc = _train_cfgs(wd, accum, warmup)
    trainable = convert.trainable_from_numpy(setup["trainable"], "cpu")
    state = ttrain.init_train_state(trainable, ttc, steps_per_epoch=SPE)
    step = ttrain.make_train_step(setup["tcfg"], ttc, setup["vtg_t"], setup["tvg_t"],
                                  device="cpu")
    frozen = _torch_frozen(setup) if frozen is None else frozen
    out = []
    for _ in range(n):
        state, m = step(state, frozen, setup["batch"], torch.from_numpy(setup["vocab"]))
        out.append((_flat(convert.params_to_numpy(state.trainable)), float(m["grad_norm"]),
                    float(m["loss"])))
    return out, state


@pytest.fixture(scope="module")
def runs(setup):
    cache = {}

    def get(wd, accum=1, n=3, warmup=0.5):
        key = (wd, accum, n, warmup)
        if key not in cache:
            cache[key] = (_jax_run(setup, wd, n, accum, warmup),
                          _torch_run(setup, wd, n, accum, warmup=warmup)[0])
        return cache[key]

    return get


@pytest.mark.parametrize("wd", [0.0, 1.0])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_steps_match_optax(runs, wd, n_steps):
    j, t = runs(wd)
    (jp, jn, jl), (tp, tn, tl) = j[n_steps - 1], t[n_steps - 1]
    assert tn == pytest.approx(jn, rel=1e-4)
    assert tl == pytest.approx(jl, abs=LOSS_ATOL, rel=LOSS_RTOL)
    for leaf in LEAVES:
        np.testing.assert_allclose(tp[leaf], jp[leaf], atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=leaf)


def test_first_warmup_step_has_zero_lr(runs, setup):
    """lr(0) = 0 under warmup: the first update moves nothing without decay."""
    t = runs(0.0)[1]
    for leaf in LEAVES:
        np.testing.assert_array_equal(t[0][0][leaf], _flat(setup["trainable"])[leaf])
    assert any(np.abs(t[1][0][leaf] - _flat(setup["trainable"])[leaf]).max() > 0
               for leaf in LEAVES)


def test_accumulation_matches_multisteps(runs, setup):
    """No warmup here, so the first applied update (after 4 micro-steps) has
    lr > 0; with warmup its lr would be 0 in both packages."""
    j, t = runs(1.0, accum=4, n=4, warmup=0.0)
    init = _flat(setup["trainable"])
    for i in range(3):  # micro-steps 1-3: nothing applied yet
        for leaf in LEAVES:
            np.testing.assert_array_equal(t[i][0][leaf], init[leaf], err_msg=leaf)
    for leaf in LEAVES:
        np.testing.assert_allclose(t[3][0][leaf], j[3][0][leaf], atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=leaf)
        assert np.abs(t[3][0][leaf] - init[leaf]).max() > 0, leaf
    for (_, jn, _), (_, tn, _) in zip(j, t):
        assert tn == pytest.approx(jn, rel=1e-4)


@pytest.mark.parametrize("frac", [0.0, 0.25, 0.49, 0.5, 1.0, 2.2, 3.0])
@pytest.mark.parametrize("warmup,min_lr", [(0.5, 0.0), (0.0, 1e-5), (1.0, 2e-5)])
def test_cosine_lr_matches_jax(frac, warmup, min_lr):
    kw = dict(lr=2e-4, min_lr=min_lr, warmup_epochs=warmup, epochs=3)
    want = float(jtrain.cosine_lr(jnp.asarray(frac, jnp.float32), jtrain.TrainConfig(**kw)))
    assert ttrain.cosine_lr(frac, ttrain.TrainConfig(**kw)) == pytest.approx(want, rel=1e-6,
                                                                            abs=1e-12)


def test_only_trainable_leaves_change(setup):
    frozen = _torch_frozen(setup)
    before = _flat(convert.params_to_numpy(frozen))
    out, state = _torch_run(setup, 1.0, 2, frozen=frozen)
    after = _flat(convert.params_to_numpy(frozen))
    assert before.keys() == after.keys()
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    init = _flat(setup["trainable"])
    for leaf in LEAVES:
        assert np.abs(out[-1][0][leaf] - init[leaf]).max() > 0, leaf
    assert not any(t.requires_grad for t in _flat(frozen).values() if t is not None)


def test_loss_decreases_on_repeated_batch(setup):
    kw = dict(lr=1e-2, warmup_epochs=0.0, epochs=5, weight_decay=0.0)
    ttc = ttrain.TrainConfig(lora=tlora.LoraConfig(dropout=0.0), **kw)
    gen = torch.Generator().manual_seed(0)
    trainable = ttrain.init_trainable(
        gen, setup["tcfg"], ttc,
        visual_head=torch.zeros(setup["tcfg"].llm.hidden_size, setup["tcfg"].mm_hidden_size) + 0.02)
    state = ttrain.init_train_state(trainable, ttc, steps_per_epoch=10)
    step = ttrain.make_train_step(setup["tcfg"], ttc, setup["vtg_t"], setup["tvg_t"], "cpu")
    frozen = _torch_frozen(setup)
    losses = []
    for _ in range(8):
        state, m = step(state, frozen, setup["batch"], torch.from_numpy(setup["vocab"]), gen)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert (state.step, state.applied) == (8, 8)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def _dataset(n=6):
    caps = [f"a dog runs number {i}" for i in range(n)]
    return RetrievalDataset("MSRVTT", caps, np.arange(n) % NVID)


def test_train_one_epoch_runs_and_averages(setup, capsys):
    _, ttc = _train_cfgs(0.0)
    trainable = convert.trainable_from_numpy(setup["trainable"], "cpu")
    state = ttrain.init_train_state(trainable, ttc, steps_per_epoch=2)
    step = ttrain.make_train_step(setup["tcfg"], ttc, setup["vtg_t"], setup["tvg_t"], "cpu")
    seen = []

    def recording_step(*args):
        state, m = step(*args)
        seen.append({k: float(v) for k, v in m.items()})
        return state, m

    ds = _dataset()
    state, avg = tloop.train_one_epoch(
        state, recording_step, _torch_frozen(setup), ds, TrainLoader(ds, batch_size=4),
        setup["feats"], torch.from_numpy(setup["vocab"]), ByteFallbackTokenizer(),
        setup["vtg_t"], setup["tvg_t"], epoch=0, device="cpu")
    assert state.step == 2 and len(seen) == 2
    for k in ("loss", "vtg_loss", "tvg_loss"):
        assert avg[k] == pytest.approx(np.mean([s[k] for s in seen]))
    assert "Averaged stats" in capsys.readouterr().out


def test_train_one_epoch_aborts_on_nan_loss(setup, capsys):
    calls = []

    def nan_step(state, frozen, batch, vocab, gen):
        calls.append(batch["vtg_input_ids"].shape)
        nan = torch.tensor(float("nan"))
        return state, {"loss": nan, "vtg_loss": nan, "tvg_loss": nan, "grad_norm": nan}

    ds = _dataset()
    with pytest.raises(SystemExit) as exc:
        tloop.train_one_epoch(None, nan_step, None, ds, TrainLoader(ds, batch_size=4),
                              setup["feats"], None, ByteFallbackTokenizer(), setup["vtg_t"],
                              setup["tvg_t"], epoch=0, device="cpu")
    assert exc.value.code == 1
    assert len(calls) == 1
    assert "Loss is nan" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# modules of the slice
# ---------------------------------------------------------------------------

def test_tvg_hidden_and_window_logits_match_jax(setup):
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jt = jax.tree_util.tree_map(jnp.asarray, setup["trainable"])
    frozen = _torch_frozen(setup)
    lora = convert.trainable_from_numpy(setup["trainable"], "cpu")["lora"]
    b = setup["batch"]
    tvg = setup["tvg_j"]
    want = np.asarray(jvcf.tvg_hidden(
        _jax_tree(setup["frozen_np"]), jcfg, jnp.asarray(b["tvg_input_ids"]),
        jnp.asarray(b["tvg_attention_mask"]), jnp.asarray(b["video"]), tvg.video_start,
        lora=jt["lora"], lora_scale=4.0, remat=True))
    with torch.no_grad():
        got = tvcf.tvg_hidden(frozen, tcfg, torch.from_numpy(b["tvg_input_ids"]),
                              torch.from_numpy(b["tvg_attention_mask"]),
                              torch.from_numpy(b["video"]), tvg.video_start, lora=lora,
                              lora_scale=4.0, remat=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    ws, wl = setup["vtg_j"].label_window
    hid = np.random.default_rng(5).standard_normal((2, 60, jcfg.llm.hidden_size)).astype(np.float32)
    jw = np.asarray(jvcf.vtg_window_logits(_jax_tree(setup["frozen_np"]), jcfg,
                                           jnp.asarray(hid), 7, 20, jt["lora"], 4.0))
    with torch.no_grad():
        tw = tvcf.vtg_window_logits(frozen, tcfg, torch.from_numpy(hid), 7, 20, lora, 4.0)
    assert tw.dtype == torch.float32
    np.testing.assert_allclose(tw.numpy(), jw, atol=1e-5, rtol=1e-4)


def test_project_tvg_and_video_vocab_match_jax(setup):
    feats = setup["feats"]
    lora = convert.trainable_from_numpy(setup["trainable"], "cpu")["lora"]["projector"]
    jt = jax.tree_util.tree_map(jnp.asarray, setup["trainable"])["lora"]["projector"]
    want = np.asarray(jprojector.project_tvg(_jax_tree(setup["frozen_np"])["projector"],
                                             jnp.asarray(feats), lora=jt, lora_scale=4.0))
    with torch.no_grad():
        got = tprojector.project_tvg(_torch_frozen(setup)["projector"], torch.from_numpy(feats),
                                     lora=lora, lora_scale=4.0)
    assert got.shape == (NVID, setup["tcfg"].num_clips, setup["tcfg"].llm.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tvcf.make_video_vocab(torch.from_numpy(feats)).numpy(),
                               np.asarray(jvcf.make_video_vocab(jnp.asarray(feats))),
                               atol=1e-6, rtol=1e-6)


def test_tvg_criteria_match_jax():
    rng = np.random.default_rng(6)
    h = rng.standard_normal((3, 4, 16)).astype(np.float32)
    vh = rng.standard_normal((16, 8)).astype(np.float32) * 0.1
    vocab = rng.standard_normal((5, 4, 8)).astype(np.float32)
    label = np.array([0, 3, 4], np.int32)
    jl = jcriteria.tvg_clip_logits(jnp.asarray(h), jnp.asarray(vh), jnp.asarray(vocab))
    tl = tcriteria.tvg_clip_logits(torch.from_numpy(h), torch.from_numpy(vh),
                                   torch.from_numpy(vocab))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    tlab = torch.from_numpy(label)
    np.testing.assert_allclose(tcriteria.tvg_likelihood(tl, tlab).numpy(),
                               np.asarray(jcriteria.tvg_likelihood(jl, jnp.asarray(label))),
                               atol=1e-5, rtol=1e-5)
    assert float(tcriteria.tvg_train_loss(tl, tlab)) == pytest.approx(
        float(jcriteria.tvg_train_loss(jl, jnp.asarray(label))), rel=1e-5)
    wl = rng.standard_normal((3, 6, 11)).astype(np.float32)
    lab = rng.integers(0, 11, (3, 6)).astype(np.int32)
    lab[0, 2:] = -100
    assert float(tcriteria.vtg_train_loss(torch.from_numpy(wl), torch.from_numpy(lab))) == \
        pytest.approx(float(jcriteria.vtg_train_loss(jnp.asarray(wl), jnp.asarray(lab))), rel=1e-5)


# ---------------------------------------------------------------------------
# decoder: forward_hidden keeps its numbers, remat changes nothing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decoder(setup):
    cfg = setup["tcfg"].llm
    frozen = _torch_frozen(setup)["llm"]
    lora = convert.trainable_from_numpy(setup["trainable"], "cpu")["lora"]["llm"]
    rng = np.random.default_rng(7)
    emb = torch.from_numpy(rng.standard_normal((2, 40, cfg.hidden_size)).astype(np.float32))
    mask = torch.ones((2, 40), dtype=torch.int32)
    mask[0, 30:] = 0
    mask[1, :5] = 0
    return cfg, frozen, lora, emb, mask


def test_forward_hidden_equals_collect_kv_hidden_bitwise(decoder):
    cfg, frozen, lora, emb, mask = decoder
    with torch.no_grad():
        h = tqwen2.forward_hidden(frozen, cfg, emb, mask, lora=lora, lora_scale=4.0)
        h_kv, kv = tqwen2.forward_collect_kv(frozen, cfg, emb, mask, lora=lora, lora_scale=4.0)
    assert torch.equal(h, h_kv)
    assert kv["k"].shape[0] == cfg.num_hidden_layers


def test_remat_changes_neither_hidden_nor_gradients(decoder):
    cfg, frozen, lora, emb, mask = decoder
    outs = []
    for remat in (False, True):
        lo = {k: {n: t.detach().clone().requires_grad_(True) for n, t in v.items()}
              for k, v in lora["layers"].items()}
        x = emb.clone().requires_grad_(True)
        h = tqwen2.forward_hidden(frozen, cfg, x, mask, lora={"layers": lo}, lora_scale=4.0,
                                  remat=remat)
        h.square().sum().backward()
        outs.append((h.detach(), x.grad, lo["q_proj"]["a"].grad, lo["o_proj"]["b"].grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_forward_hidden_matches_jax(setup, decoder):
    cfg, frozen, lora, emb, mask = decoder
    jllm = _jax_tree(setup["frozen_np"])["llm"]
    jl = jax.tree_util.tree_map(jnp.asarray, setup["trainable"])["lora"]["llm"]
    want = np.asarray(jqwen2.forward_hidden(jllm, setup["jcfg"].llm, jnp.asarray(emb.numpy()),
                                            jnp.asarray(mask.numpy()), lora=jl, lora_scale=4.0,
                                            remat=True))
    with torch.no_grad():
        got = tqwen2.forward_hidden(frozen, cfg, emb, mask, lora=lora, lora_scale=4.0, remat=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# LoRA: init and dropout
# ---------------------------------------------------------------------------

def test_lora_init_shapes_and_distribution(setup):
    cfg = setup["tcfg"]
    gen = torch.Generator().manual_seed(0)
    t = ttrain.init_trainable(gen, cfg, ttrain.TrainConfig(),
                              visual_head=torch.full((cfg.llm.hidden_size, cfg.mm_hidden_size),
                                                     0.02))
    tf = _flat(t)
    jf = _flat(_np(jtrain.init_trainable(
        jax.random.key(0), setup["jcfg"], jtrain.TrainConfig(),
        visual_head=jnp.zeros((cfg.llm.hidden_size, cfg.mm_hidden_size)) + 0.02)))
    assert tf.keys() == jf.keys()
    for k in tf:
        assert tuple(tf[k].shape) == jf[k].shape, k
        assert tf[k].dtype == torch.float32 and tf[k].requires_grad and tf[k].is_leaf, k
        if k.endswith("/b"):
            assert not tf[k].any(), k
        elif k.endswith("/a"):
            bound = 1.0 / math.sqrt(tf[k].shape[-2])
            top = float(tf[k].detach().abs().max())
            assert 0.9 * bound < top <= bound, k
    for fc in ("fc1", "fc2"):  # tvg_mlp starts as a copy of mlp, in its own storage
        p = t["lora"]["projector"]
        assert torch.equal(p["tvg_mlp"][fc]["a"], p["mlp"][fc]["a"])
        assert p["tvg_mlp"][fc]["a"].data_ptr() != p["mlp"][fc]["a"].data_ptr()


@pytest.mark.parametrize("p_drop", [0.05, 0.5])
def test_lora_dropout_keep_rate_and_scale(p_drop):
    """LoRA dropout on the projector's dense layers: each input element of
    the LoRA branch is kept with probability 1 - p and scaled by 1/(1 - p);
    the base product sees the undropped input."""
    n, rows = 256, 512
    dense = {"kernel": torch.zeros(n, n), "bias": torch.zeros(n)}
    lora = {"a": torch.eye(n), "b": torch.eye(n)}
    x = torch.ones(rows, n)
    gen = torch.Generator().manual_seed(1)
    y = tlora.apply_dense(dense, x, lora, 1.0, p_drop, gen)
    kept = y != 0
    rate = float(kept.float().mean())
    sigma = math.sqrt(p_drop * (1 - p_drop) / (rows * n))
    assert abs(rate - (1 - p_drop)) < 5 * sigma
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - p_drop)))
    assert torch.equal(tlora.apply_dense(dense, x, lora, 1.0, p_drop, None), x)
    assert torch.equal(tlora.apply_dense(dense, x, lora, 1.0, 0.0, gen), x)
    y2 = tlora.apply_dense(dense, x, lora, 1.0, p_drop, torch.Generator().manual_seed(1))
    assert torch.equal(y, y2)


def test_projector_dropout_draws_from_the_generator(setup):
    frozen = _torch_frozen(setup)["projector"]
    lora = convert.trainable_from_numpy(setup["trainable"], "cpu")["lora"]["projector"]
    feats = torch.from_numpy(setup["feats"])
    with torch.no_grad():
        plain = tprojector.project_vtg(frozen, feats, lora, 4.0)
        a = tprojector.project_vtg(frozen, feats, lora, 4.0, lora_dropout=0.3,
                                   generator=torch.Generator().manual_seed(2))
        b = tprojector.project_vtg(frozen, feats, lora, 4.0, lora_dropout=0.3,
                                   generator=torch.Generator().manual_seed(2))
        c = tprojector.project_vtg(frozen, feats, lora, 4.0, lora_dropout=0.3,
                                   generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert not torch.equal(a, plain) and not torch.equal(a, c)
