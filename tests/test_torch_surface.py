"""The port's public surface against the JAX package's.

An AST diff of the top-level names (functions, classes, assignments) and
the public method names of every module of blim_tpu against the module at
the same path in blim_tpu_torch (where a name the port imports into the
module counts as present). What the JAX package has and the port lacks
must be exactly the TPU-only list that ROADMAP.md's queue A names ("Left
out by design"), so a new gap, or a listed name that is ported after all,
fails here."""

import ast
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
MODULE = "<module>"     # the whole module is left out

# ROADMAP.md, queue A, "Left out by design": TPU-only by design
TPU_ONLY = {
    "checkpoints/orbax_io.py": {MODULE, "load_checkpoint", "save_checkpoint"},
    "core/mesh.py": {MODULE, "DATA_AXIS", "MODEL_AXIS", "data_sharded", "local_mesh",
                     "make_mesh", "process_shard_bounds", "replicated"},
    "core/precision.py": {MODULE, "DEFAULT", "FP32", "Policy", "cast_pytree"},
    "engine/aot_cache.py": {MODULE, "AOTStep", "AOTStep.clear_cache", "aot_cache_dir",
                            "aot_enabled", "stats"},
    "engine/evaluation.py": {"warm_session"},
    "engine/rerank.py": {"step_jit", "clear_step_caches", "ladder_batches",
                         "RerankEngine.warmup_packed", "RerankEngine.packed_combo_sets",
                         "RerankEngine.flush_feats"},
    "engine/train.py": {"param_shardings"},
    # initializers drawing from jax.random, which no torch initializer can
    # match: the port has checkpoints/convert.init_params / init_vision_tower
    "models/projector.py": {"init_params"},
    "models/qwen2.py": {"init_params"},
    "models/umt_vit.py": {"init_params"},
    "models/videochat_flash.py": {"init_params"},
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def surface(path: Path, with_imports: bool) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if _public(node.name):
                names.add(node.name)
                if isinstance(node, ast.ClassDef):
                    names.update(f"{node.name}.{sub.name}" for sub in node.body
                                 if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                                 and _public(sub.name))
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name) and _public(t.id))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            if _public(node.target.id):
                names.add(node.target.id)
        elif with_imports and isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names if _public(a.asname or a.name))
    return names


def missing_from_the_port() -> dict:
    gaps = {}
    for path in sorted((REPO / "blim_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "blim_tpu").as_posix()
        port = REPO / "blim_tpu_torch" / rel
        have = surface(port, with_imports=True) if port.exists() else set()
        gap = surface(path, with_imports=False) - have
        if not port.exists():
            gap.add(MODULE)
        if gap:
            gaps[rel] = gap
    return gaps


def test_the_port_lacks_only_the_tpu_only_names():
    assert missing_from_the_port() == TPU_ONLY


def test_the_diff_sees_a_gap():
    """The diff's own check: methods, assignments and whole modules count,
    an import into the port's module covers a name."""
    jax_side = surface(REPO / "blim_tpu" / "engine" / "rerank.py", with_imports=False)
    assert {"RerankEngine", "RerankEngine.close", "RerankEngine.reset_flops",
            "build_packs"} <= jax_side
    assert "NEG_INF" in surface(REPO / "blim_tpu_torch" / "kernels" / "flash_attention.py",
                                with_imports=True)
    assert "NEG_INF" not in surface(REPO / "blim_tpu_torch" / "kernels" / "flash_attention.py",
                                    with_imports=False)
    assert MODULE in missing_from_the_port()["core/mesh.py"]
