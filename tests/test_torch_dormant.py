"""The port's dormant features against the JAX package's, on the CPU at the
tiny config in fp32 (JAX's attention on its XLA path, as its own tests run
it on the CPU):

  * PyramidDrop (models/pyramid_drop.py, `videochat_flash.vtg_hidden_pdrop`
    and `pdrop_total_dropped`), on the oracles of tests/test_pyramid_drop.py:
    a keep-all ratio list equals the plain decoder forward; a uniform drop
    equals layer 0 on the full sequence, the kept tokens gathered and the
    other layers on the short sequence at renumbered positions; the
    attention ranking and the tokens it keeps; two stages with
    uniform0_attention; a LoRA tree; the config plumbing; each also against
    JAX's output within atol 1e-5 / rtol 1e-4 (fp32 sums in another order
    through two layers) and its kept-index map exactly;
  * the plain windowed attention (the window runs as torch ops on every
    device) against tests/test_sliding_window.py's numpy oracle, the decoder
    with a sliding window against JAX's, and its gradient against JAX's;
  * utils/lr_decay.py against blim_tpu/utils/lr_decay.py;
  * utils/profiling.py on the CPU (a trace file is written naming a span,
    None is a no-op) and `pipelines.main --tiny --device cpu --profile_dir`
    (its trace names the evaluation's spans).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blim_tpu.core.config import tiny_model_config as jax_tiny_config
from blim_tpu.kernels import attention as jattention
from blim_tpu.models import pyramid_drop as jpd
from blim_tpu.models import qwen2 as jq
from blim_tpu.models import videochat_flash as jvcf
from blim_tpu.utils import lr_decay as jlr

from blim_tpu_torch.checkpoints.convert import params_from_numpy
from blim_tpu_torch.core.config import tiny_model_config
from blim_tpu_torch.kernels.attention import multi_head_attention
from blim_tpu_torch.models import pyramid_drop as tpd
from blim_tpu_torch.models import qwen2 as tq
from blim_tpu_torch.models import videochat_flash as tvcf
from blim_tpu_torch.utils import lr_decay as tlr
from blim_tpu_torch.utils import profiling
from test_sliding_window import _numpy_windowed_attention
from test_torch_tvg import _lora_numpy

torch.backends.cuda.matmul.allow_tf32 = False

ATOL, RTOL = 1e-5, 1e-4
B, S, NV, VSTART = 2, 40, 16, 6       # 6 prefix | 16 video | 18 suffix
QPOS = VSTART + NV + 3                # the last instruction token


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def llm():
    """The tiny decoder (vocab 128) at 3 layers in both packages (a rank
    layer must exist: two stages rank with layers 1 and 2), right-padded
    embeds."""
    jcfg = dataclasses.replace(jax_tiny_config(vocab_size=128).llm, num_hidden_layers=3)
    tcfg = dataclasses.replace(tiny_model_config(vocab_size=128).llm, num_hidden_layers=3)
    jp = jq.init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), torch.float32, "cpu")
    rng = np.random.default_rng(0)
    emb = (rng.standard_normal((B, S, jcfg.hidden_size)) * 0.3).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, -4:] = 0
    return jcfg, tcfg, jp, tp, emb, mask


def _pdrop(llm, layer_list, ratio_list, compress_type, lora=None, remat=False):
    jcfg, tcfg, jp, tp, emb, mask = llm
    jout, jidx = jpd.pdrop_forward_hidden(
        jp, jcfg, jnp.asarray(emb), jnp.asarray(mask), VSTART, NV, QPOS, layer_list=layer_list,
        ratio_list=ratio_list, compress_type=compress_type,
        lora=None if lora is None else jax.tree_util.tree_map(jnp.asarray, lora),
        lora_scale=4.0)
    tout, tidx = tpd.pdrop_forward_hidden(
        tp, tcfg, _t(emb), _t(mask), VSTART, NV, QPOS, layer_list=layer_list,
        ratio_list=ratio_list, compress_type=compress_type,
        lora=None if lora is None else params_from_numpy(lora, torch.float32, "cpu"),
        lora_scale=4.0, remat=remat)
    _close(tout, jout)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    return tout, tidx


def test_pdrop_keep_all_matches_plain_forward_and_jax(llm):
    _, tcfg, _, tp, emb, mask = llm
    out, idx = _pdrop(llm, [1], [1.0, 1.0], "uniform")
    _close(out, tq.forward_hidden(tp, tcfg, _t(emb), _t(mask)).numpy(), atol=0, rtol=0)
    np.testing.assert_array_equal(idx.numpy(), np.broadcast_to(np.arange(S), (B, S)))


def test_pdrop_uniform_drop_matches_manual_resplice_and_jax(llm):
    _, tcfg, _, tp, emb, mask = llm
    keep = NV // 2
    out, idx = _pdrop(llm, [1], [1.0, 0.5], "uniform")
    lin = np.linspace(0, NV - 1, keep).astype(np.int64)
    kept = np.concatenate([np.arange(VSTART), lin + VSTART, np.arange(VSTART + NV, S)])
    assert out.shape == (B, len(kept), tcfg.hidden_size)
    np.testing.assert_array_equal(idx.numpy(), np.broadcast_to(kept, (B, len(kept))))
    pos = torch.arange(S)[None].expand(B, S)
    h = tpd._run_segment(tpd._slice_layers(tp["layers"], 0, 1), tcfg, _t(emb), _t(mask), pos,
                         None, 0.0, False)[:, kept]
    s2 = len(kept)
    h = tpd._run_segment(tpd._slice_layers(tp["layers"], 1, tcfg.num_hidden_layers), tcfg, h,
                         _t(mask)[:, kept], torch.arange(s2)[None].expand(B, s2), None, 0.0,
                         False)
    _close(out, tq.rms_norm(h, tp["norm"]["scale"], tcfg.rms_norm_eps).numpy(), atol=1e-6,
           rtol=1e-5)


def test_pdrop_attention_ranking_matches_jax(llm):
    jcfg, tcfg, jp, tp, emb, mask = llm
    pos = np.broadcast_to(np.arange(S), (B, S))
    got = tpd.rank_video_tokens(tq._layer_slice(tp["layers"], 1), tcfg, _t(emb), _t(mask),
                                _t(pos), QPOS, VSTART, NV)
    want = jpd.rank_video_tokens(jax.tree_util.tree_map(lambda x: x[1], jp["layers"]), jcfg,
                                 jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(pos), QPOS,
                                 VSTART, NV)
    assert got.shape == (B, NV) and got.dtype == torch.float32
    _close(got, want, atol=1e-7, rtol=1e-4)
    keep = 4
    _, idx = _pdrop(llm, [1], [1.0, keep / NV], "attention")
    expect = np.sort(np.argsort(-got.numpy(), axis=1)[:, :keep], axis=1)
    np.testing.assert_array_equal(idx.numpy()[:, VSTART: VSTART + keep] - VSTART, expect)


@pytest.mark.parametrize("remat", [False, True])
def test_pdrop_multi_stage_uniform0_attention_matches_jax(llm, remat):
    _, tcfg, _, _, _, _ = llm
    out, idx = _pdrop(llm, [1, 2], [1.0, 0.5, 0.25], "uniform0_attention", remat=remat)
    final = int(NV * 0.25)
    assert out.shape == (B, S - (NV - final), tcfg.hidden_size)
    np.testing.assert_array_equal(idx.numpy()[:, :VSTART], np.broadcast_to(np.arange(VSTART),
                                                                          (B, VSTART)))
    np.testing.assert_array_equal(idx.numpy()[:, VSTART + final:],
                                  np.broadcast_to(np.arange(VSTART + NV, S), (B, S - VSTART - NV)))


def test_pdrop_with_lora_matches_jax(llm):
    jcfg = jax_tiny_config(vocab_size=128, num_clips=4)
    jcfg = dataclasses.replace(jcfg, llm=llm[0])
    _pdrop(llm, [1], [1.0, 0.5], "attention", lora=_lora_numpy(jcfg, 11)["llm"])


def test_pdrop_unknown_compress_type_raises(llm):
    _, tcfg, _, tp, emb, mask = llm
    with pytest.raises(NotImplementedError):
        tpd.pdrop_forward_hidden(tp, tcfg, _t(emb), _t(mask), VSTART, NV, QPOS, [1], [1.0, 0.5],
                                 compress_type="pooling")


def test_pdrop_config_plumbing_and_vcf_entry_match_jax():
    from blim_tpu_torch.core.config import from_hf_config_dict

    d = {"mm_llm_compress": True, "llm_compress_layer_list": [8, 16, 24],
         "llm_image_token_ratio_list": [1.0, 0.5, 0.25, 0.125]}
    mc = from_hf_config_dict(d)
    assert mc.mm_llm_compress and mc.llm_compress_layer_list == (8, 16, 24)
    assert tvcf.pdrop_total_dropped(mc) == jvcf.pdrop_total_dropped(mc) > 0
    assert tvcf.pdrop_total_dropped(tiny_model_config()) == 0
    kw = dict(mm_llm_compress=True, llm_compress_layer_list=(1,),
              llm_image_token_ratio_list=(1.0, 0.5), llm_compress_type="uniform")
    jcfg = dataclasses.replace(jax_tiny_config(vocab_size=152064), **kw)
    tcfg = dataclasses.replace(tiny_model_config(vocab_size=152064), **kw)
    assert tvcf.pdrop_total_dropped(tcfg) == jvcf.pdrop_total_dropped(jcfg) == \
        tcfg.video_tokens_vtg // 2
    jp = jvcf.init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), torch.float32, "cpu")
    rng = np.random.default_rng(1)
    T = tcfg.video_tokens_vtg + 40
    ids = rng.integers(0, 1000, (2, T)).astype(np.int64)
    m = np.ones((2, T), np.int32)
    m[1, -5:] = 0
    video = rng.standard_normal((2, tcfg.num_clips, tcfg.tokens_per_clip,
                                 tcfg.mm_hidden_size)).astype(np.float32)
    qpos = 4 + tcfg.video_tokens_vtg + 2
    want, jidx = jvcf.vtg_hidden_pdrop(jp, jcfg, jnp.asarray(ids), jnp.asarray(m),
                                       jnp.asarray(video), video_start=4, query_pos=qpos)
    got, tidx = tvcf.vtg_hidden_pdrop(tp, tcfg, _t(ids), _t(m), _t(video), 4, qpos)
    assert got.shape == (2, T - tvcf.pdrop_total_dropped(tcfg), tcfg.llm.hidden_size)
    _close(got, want)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    # keep-all: vtg_hidden exactly
    keep_all = dataclasses.replace(tcfg, llm_image_token_ratio_list=(1.0, 1.0))
    full, _ = tvcf.vtg_hidden_pdrop(tp, keep_all, _t(ids), _t(m), _t(video), 4, qpos)
    _close(full, tvcf.vtg_hidden(tp, tcfg, _t(ids), _t(m), _t(video), 4).numpy(), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the sliding window
# ---------------------------------------------------------------------------

def test_window_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    b, s, hq, hkv, d = 2, 10, 4, 2, 8
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for h in (hq, hkv, hkv))
    for w in (1, 3, 7):
        got = multi_head_attention(_t(q), _t(k), _t(v), causal=True, scale=d ** -0.5, window=w)
        want = _numpy_windowed_attention(q, k, v, w, d ** -0.5)
        _close(got, want, atol=1e-5, rtol=1e-5)


def test_windowed_decoder_matches_jax():
    kw = dict(use_sliding_window=True, sliding_window=3, max_window_layers=1)
    jcfg = dataclasses.replace(jax_tiny_config(vocab_size=256).llm, **kw)
    tcfg = dataclasses.replace(tiny_model_config(vocab_size=256).llm, **kw)
    jp = jq.init_params(jcfg, jax.random.key(4))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), torch.float32, "cpu")
    emb = np.random.default_rng(5).standard_normal((2, 10, jcfg.hidden_size)).astype(np.float32)
    want = jq.forward_hidden(jp, jcfg, jnp.asarray(emb), use_pallas=False)
    got = tq.forward_hidden(tp, tcfg, _t(emb))
    _close(got, want)
    plain = tq.forward_hidden(tp, dataclasses.replace(tcfg, use_sliding_window=False), _t(emb))
    assert (got - plain).abs().max() > 1e-3


def test_windowed_attention_gradient_matches_jax():
    rng = np.random.default_rng(6)
    b, s, hq, hkv, d, w = 1, 9, 4, 2, 8, 2
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for h in (hq, hkv, hkv))
    km = np.ones((b, s), np.int32)
    km[0, -2:] = 0

    def jloss(q, k, v):
        out = jattention._xla_attention(q, k, v, jnp.asarray(km), jnp.asarray(km), True,
                                        d ** -0.5, jnp.int32(w))
        return (out * out).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq_, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = multi_head_attention(tq_, tk, tv, key_mask=_t(km), query_mask=_t(km), causal=True,
                               scale=d ** -0.5, window=w)
    (out * out).sum().backward()
    for t, j in zip((tq_, tk, tv), jg):
        _close(t.grad, j, atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# lr_decay and profiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,decay", [(4, 0.5), (28, 0.75)])
def test_layer_scale_vector_matches_jax(n, decay):
    got = tlr.layer_scale_vector(n, decay)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlr.layer_scale_vector(n, decay)))


def test_stacked_tree_scales_and_scale_updates_match_jax():
    shapes = {"a": (4, 3, 2), "b": (7,), "c": {"d": (4, 5), "e": ()}}

    def tree(fn, node=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in node.items()}

    rng = np.random.default_rng(8)
    upd = tree(lambda s: np.asarray(rng.standard_normal(s), np.float32))
    jscales = jlr.stacked_tree_scales(tree(jnp.zeros), 4, 0.5)
    tscales = tlr.stacked_tree_scales(tree(torch.zeros), 4, 0.5)
    assert tscales["a"].shape == (4, 1, 1) and float(tscales["b"]) == 1.0
    tx = jlr.scale_updates_by(jscales)
    jupd, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, upd), tx.init(None))
    tupd = tlr.scale_updates_by(jax.tree_util.tree_map(torch.from_numpy, upd), tscales)
    for path in (("a",), ("b",), ("c", "d"), ("c", "e")):
        t, j, s_t, s_j = tupd, jupd, tscales, jscales
        for p in path:
            t, j, s_t, s_j = t[p], j[p], s_t[p], s_j[p]
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        np.testing.assert_array_equal(np.broadcast_to(s_t.numpy(), np.shape(s_j)),
                                      np.asarray(s_j))


def test_trace_writes_a_chrome_trace_and_none_is_a_noop(tmp_path, capsys):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("blim_scope"):
            (x @ x).sum()
    trace = json.loads((tmp_path / "prof" / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "blim_scope" in names
    with profiling.trace(None):
        (x @ x).sum()
    assert not (tmp_path / "none").exists()


def test_cli_eval_with_profile_dir(tmp_path):
    from blim_tpu_torch.engine import loop as tloop
    from test_torch_distributed import _cli_common, _cli_run, _write_data_root

    root = tmp_path / "data"
    _write_data_root(root)
    prof = tmp_path / "prof"
    results = _cli_run(["--eval", "--profile_dir", str(prof),
                        *_cli_common(root, tmp_path / "out")])
    trace = json.loads((prof / "trace.json").read_text())
    assert len(trace["traceEvents"]) > 100
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"evaluation", "rerank.vtg", "rerank.dispatch"} <= names    # the program's spans
    log = (tmp_path / "out" / "log.txt").read_text()
    assert tloop.results_table(results) in log and "blim" in results
