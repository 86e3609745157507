"""The port's zero-shot slice end to end against the JAX package's: the
evaluation (CPN on, TVG off, shared-prefix packed scoring) on 8 items with
topk 4 gives the same three score matrices and the same recall tables as
the JAX evaluation on a one-device mesh. Tiny config, fp32 on the CPU;
matrices within atol 1e-4 / rtol 1e-4 (fp32 through two layers and a
152k-way CE), fill cells exactly -100, recall tables equal. The fine-tuned
flow (TVG on) is held to JAX in tests/test_torch_finetuned.py.

Also: the TVG directions refuse an engine without a TVG layout, the port
imports nothing of JAX or the JAX package, and chip_smoke.py refuses to
run without a GPU or without the package beside it."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax

from blim_tpu.core.config import tiny_model_config as jax_tiny_config
from blim_tpu.core.mesh import make_mesh
from blim_tpu.data.prompts import make_vtg_layout as jax_make_vtg_layout
from blim_tpu.engine import evaluation as jeval
from blim_tpu.engine.rerank import RerankEngine as JaxRerankEngine
from blim_tpu.models import videochat_flash as jvcf
from blim_tpu.scoring import fusion as jfusion

from blim_tpu_torch.checkpoints.convert import params_from_numpy
from blim_tpu_torch.core.config import tiny_model_config
from blim_tpu_torch.data.prompts import make_vtg_layout
from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
from blim_tpu_torch.engine import evaluation as teval
from blim_tpu_torch.engine.rerank import RerankEngine, topk_pairs
from blim_tpu_torch.kernels import flash_attention as tfa
from blim_tpu_torch.scoring import fusion as tfusion

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = Path(__file__).resolve().parents[1]
N, TOPK = 8, 4
CAPTIONS = [
    "a cat sits on a mat",
    "a man rides a horse through a field",
    "children play soccer in the park",
    "a chef cooks pasta in a kitchen",
    "a dog catches a frisbee",
    "two people dance under the lights",
    "a train crosses a long bridge",
    "waves crash against the rocks",
]
MATRICES = [("v2t", "candidate_likelihood"), ("v2t", "candidate_prior"),
            ("t2v", "query_likelihood"), ("v2t", "internvideo2"), ("t2v", "internvideo2")]


@pytest.fixture(scope="module")
def both(tokenizer):
    jcfg = jax_tiny_config(vocab_size=152064, num_clips=4)
    tcfg = tiny_model_config(vocab_size=152064, num_clips=4)
    jp = jvcf.init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), torch.float32, "cpu")
    rng = np.random.default_rng(0)
    feats = rng.standard_normal(
        (N, tcfg.num_clips, tcfg.tokens_per_clip, tcfg.mm_hidden_size)).astype(np.float32) * 0.5
    # InternVideo2 stand-ins, kept off exact 0.0 (the recall sentinel)
    t2v_iv2 = rng.standard_normal((N, N)).astype(np.float32) + 0.1
    v2t_iv2 = rng.standard_normal((N, N)).astype(np.float32) + 0.1

    jl = jax_make_vtg_layout(tokenizer, "MSRVTT", jcfg.video_tokens_vtg, max_caption_tokens=48)
    jengine = JaxRerankEngine(jp, jcfg, jl, None, make_mesh(devices=jax.devices()[:1]))
    jt2v, jv2t = jeval.evaluation(
        jengine, jeval.EvalInputs(CAPTIONS, np.arange(N), feats, t2v_iv2, v2t_iv2),
        tokenizer, "MSRVTT", topk=TOPK, cpn=True, has_tvg=False, verbose=False)

    ttok = ByteFallbackTokenizer()
    tl = make_vtg_layout(ttok, "MSRVTT", tcfg.video_tokens_vtg, max_caption_tokens=48)
    tengine = RerankEngine(tp, tcfg, tl, device="cpu")
    tfa.launches = 0
    tt2v, tv2t = teval.evaluation(
        tengine, teval.EvalInputs(CAPTIONS, np.arange(N), feats, t2v_iv2, v2t_iv2),
        ttok, "MSRVTT", topk=TOPK, cpn=True, has_tvg=False, verbose=False)
    launches = tfa.launches
    return {"jax": {"t2v": jt2v, "v2t": jv2t}, "torch": {"t2v": tt2v, "v2t": tv2t},
            "v2t_iv2": v2t_iv2, "t2v_iv2": t2v_iv2, "launches": launches,
            "engine": tengine}


@pytest.mark.parametrize("direction,name", MATRICES, ids=[f"{d}-{n}" for d, n in MATRICES])
def test_zero_shot_matrices_match_jax(both, direction, name):
    t = both["torch"][direction][name]
    j = both["jax"][direction][name]
    assert t.shape == j.shape == (N, N)
    np.testing.assert_array_equal(t == -100.0, j == -100.0)
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=1e-4)


def test_zero_shot_keys_and_fill(both):
    t = both["torch"]
    assert set(t["v2t"]) == set(both["jax"]["v2t"])
    assert set(t["t2v"]) == set(both["jax"]["t2v"])
    rows, cols = topk_pairs(both["v2t_iv2"], TOPK)
    owned = np.zeros((N, N), bool)
    owned[rows, cols] = True
    for name in ("candidate_likelihood", "candidate_prior"):
        assert (t["v2t"][name][~owned] == -100.0).all()
        assert np.isfinite(t["v2t"][name][owned]).all()
        assert (t["v2t"][name][owned] > -100.0).all()


@pytest.mark.parametrize("cpn", [True, False])
def test_recall_tables_match_jax(both, cpn):
    ids = {i: i for i in range(N)}
    args = (ids, ids, (0.0, 0.8), (1.0, 0.0, 0.8, 0.6), cpn, False)
    t = tfusion.all_scoring_results(both["torch"]["t2v"], both["torch"]["v2t"], *args)
    j = jfusion.all_scoring_results(both["jax"]["t2v"], both["jax"]["v2t"], *args)
    assert t == j


def test_cpu_slice_never_launches_the_kernel(both):
    assert both["launches"] == 0
    assert both["engine"].prefix_forwards > 1


def test_tvg_directions_need_a_tvg_layout(both):
    assert both["engine"].tvg_layout is None
    with pytest.raises(ValueError, match="tvg_layout"):
        teval.evaluation(both["engine"], None, None, "MSRVTT", has_tvg=True)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((REPO / "blim_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "scripts" / "profile_torch_flow.py",
        REPO / "scripts" / "parity_torch.py", REPO / "scripts" / "analyze_schedule_torch.py",
        REPO / "scripts" / "ablate_bwd_dense_torch.py",
        REPO / "scripts" / "ablate_fwd_dense_torch.py", REPO / "scripts" / "ablate_fwd_torch.py",
        REPO / "scripts" / "ablation_torch.py"]
    assert len(files) > 10
    names = {f.relative_to(REPO).as_posix() for f in files}
    for module in ("adapters/lora", "checkpoints/convert", "checkpoints/safetensors_io",
                   "checkpoints/state_io", "core/config", "data/collate", "data/conversation",
                   "data/datasets", "data/features", "data/images", "data/native_pack",
                   "data/prompts", "data/tokenization", "data/video", "engine/train",
                   "engine/loop", "kernels/flash_attention", "kernels/attention",
                   "models/generation", "models/qwen2", "models/projector", "models/umt_vit",
                   "models/videochat_flash", "models/pyramid_drop", "pipelines/configs",
                   "pipelines/extract", "pipelines/main", "scoring/criteria",
                   "scoring/alt_metrics", "scoring/recall", "utils/distributed",
                   "utils/logging", "utils/lr_decay", "utils/profiling", "utils/flops",
                   "scoring/fusion", "core/constants"):
        assert f"blim_tpu_torch/{module}.py" in names, module
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "blim_tpu", "flax", "optax", "bench"), (f, mod)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_gpu_or_the_package(tmp_path, where):
    script = REPO / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env_cmd = [sys.executable, "-c",
               "import runpy, sys, torch; torch.cuda.is_available = lambda: False; "
               f"sys.argv = [{str(script)!r}]; runpy.run_path({str(script)!r}, run_name='__main__')"]
    proc = subprocess.run(env_cmd, capture_output=True, text=True, timeout=120,
                          cwd=script.parent)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert ("not next to" if where == "alone" else "is_available() is false") in proc.stderr
