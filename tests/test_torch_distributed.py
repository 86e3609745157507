"""Data parallel over processes, on the CPU (the naive per-pair schedule's
tests are in tests/test_torch_naive.py).

Two ranks are started with torch.multiprocessing (spawn) in a gloo group on
a free localhost port; each group of ranks is joined with its own timeout
and killed on expiry. One spawn carries most checks, while the parent
computes the JAX references; the ranks run only the port (this module
imports JAX lazily, inside the parent's fixtures). Tiny config, fp32,
weights and LoRA (B factors made non-zero) bridged from the JAX trees.

  * at world 1, without a launcher's environment, nothing changes: no
    group, rank 0 of 1, every reduction returns its input;
  * the sharded zero-shot and fine-tuned `evaluation` at world 2: every
    matrix on every rank within 1e-4 of the JAX single-process evaluation,
    identical across the ranks, the ranks' pack shards disjoint and
    covering every bucket; a planted fault, one rank skipping its merge,
    fails rank 0 and leaves rank 1's matrices wrong;
  * the data-parallel train step at world 2: trees identical across the
    ranks after every step; with the same label count in both halves, the
    averaged gradient equals JAX's on the joined batch and the trees the
    optax step's (test_torch_train's PARAM_ATOL / PARAM_RTOL); with unequal
    counts (the VTG loss is a token mean) it equals the mean of the halves'
    gradients and differs from the joined batch's; accumulation over 2
    micro-steps makes one all-reduce;
  * the sharded rectangle schedule (`evaluation(packed=False)`), zero-shot
    and fine-tuned, in the same spawn: every matrix on every rank within
    1e-4 of JAX's single-process rectangle evaluation, identical across the
    ranks, each k-bucket's groups split into disjoint shards that cover it;
  * SmoothedValue / MetricLogger sums and all_reduce_mean at world 2;
  * pipelines.main under 2 ranks with --tiny --device cpu (eval, one
    epoch, --resume): only rank 0 writes log.txt and checkpoints, the
    sharded eval's table equals the one-process run's, the resumed eval's
    equals the epoch's and a one-process eval of the same checkpoint.
"""

import argparse
import builtins
import json
import os
import pickle
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from blim_tpu_torch.adapters.lora import LoraConfig
from blim_tpu_torch.checkpoints import convert
from blim_tpu_torch.core.config import tiny_model_config
from blim_tpu_torch.data import datasets as tdatasets
from blim_tpu_torch.data.prompts import make_tvg_layout, make_vtg_layout
from blim_tpu_torch.data.tokenization import ByteFallbackTokenizer
from blim_tpu_torch.engine import evaluation as teval
from blim_tpu_torch.engine import train as ttrain
from blim_tpu_torch.engine.rerank import RerankEngine
from blim_tpu_torch.utils import distributed as dist
from blim_tpu_torch.utils.logging import MetricLogger, SmoothedValue

WORLD = 2
SPAWN_TIMEOUT_S = 240        # the whole group of ranks, imports included
GROUP_TIMEOUT_S = 120        # a collective's wait inside it
FAULT_GROUP_TIMEOUT_S = 20
N, TOPK, CAPS = 8, 4, 48
SCALE = LoraConfig().scale
ATOL = RTOL = 1e-4           # port against JAX, fp32
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4   # tests/test_torch_train.py's
GRAD_REL = 1e-4
SPE = 4
RECT_PRIOR_BATCH = 4         # captions a rectangle prior step (64 by default) in both
                             # packages: less padding of the 152k-vocabulary CE on the CPU
CAPTIONS = ["a cat sits on a mat", "a man rides a horse through a field",
            "children play soccer in the park", "a chef cooks pasta in a kitchen",
            "a dog catches a frisbee", "two people dance under the lights",
            "a train crosses a long bridge", "waves crash against the rocks"]
# train batches of 4 split into halves [0, 1] and [2, 3]: EQUAL's halves
# carry the same caption tokens (10 + 14 each), UNEQUAL's do not (20 vs 26)
TRAIN_CAPTIONS = {"equal": ["a cat sits", "kids play ball", "a dog runs", "kids kick ball"],
                  "unequal": ["a cat sits", "a man runs", "kids play ball", "a chef cooks"]}
WORDS = ["man", "dog", "runs", "park", "sings", "car", "cooks", "kitchen", "a", "the"]
FLOWS = {"zeroshot": False, "finetuned": True}
MATRICES = {
    "zeroshot": [("v2t", "candidate_likelihood"), ("v2t", "candidate_prior"),
                 ("t2v", "query_likelihood")],
    "finetuned": [("v2t", "candidate_likelihood"), ("v2t", "candidate_prior"),
                  ("v2t", "query_likelihood"), ("t2v", "query_likelihood"),
                  ("t2v", "candidate_likelihood"), ("t2v", "candidate_prior")],
}
CELLS = [(flow, d, n) for flow, mats in MATRICES.items() for d, n in mats]
CELL_IDS = [f"{f}-{d}-{n}" for f, d, n in CELLS]


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, port, out_dir, group_timeout):
    """A rank's body: the launcher's environment, a gloo group, fn(rank),
    its result pickled to out_dir/rank{rank}.pkl."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    print_ = builtins.print
    try:
        dist.init_distributed_mode(backend="gloo", device="cpu", timeout=group_timeout)
        out = fn(rank, out_dir)
    finally:
        builtins.print = print_
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class Ranks:
    """A group of WORLD spawned ranks running fn; join() waits for them
    within SPAWN_TIMEOUT_S of the start, kills them on expiry, and returns
    their results in rank order."""

    def __init__(self, fn, out_dir, group_timeout=GROUP_TIMEOUT_S, world=WORLD):
        self.out_dir, self.world, self.t0 = str(out_dir), world, time.time()
        self.ctx = mp.start_processes(
            _rank_main, args=(fn, world, _free_port(), self.out_dir, group_timeout),
            nprocs=world, join=False, start_method="spawn")

    def join(self):
        try:
            while not self.ctx.join(timeout=1.0):
                if time.time() - self.t0 > SPAWN_TIMEOUT_S:
                    raise TimeoutError(f"ranks still running after {SPAWN_TIMEOUT_S}s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
        out = []
        for r in range(self.world):
            with open(os.path.join(self.out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ---------------------------------------------------------------------------
# shared inputs (written by the parent, read by every rank)
# ---------------------------------------------------------------------------

def _inputs(out_dir):
    with open(os.path.join(out_dir, "..", "inputs.pkl"), "rb") as f:
        return pickle.load(f)


def _engine(inp, has_tvg):
    cfg = tiny_model_config(vocab_size=152064, num_clips=4)
    tok = ByteFallbackTokenizer()
    params = convert.params_from_numpy(inp["params"], torch.float32, "cpu")
    lora = convert.params_from_numpy(inp["lora"], device="cpu") if has_tvg else None
    engine = RerankEngine(params, cfg, make_vtg_layout(tok, "MSRVTT", cfg.video_tokens_vtg, CAPS),
                          make_tvg_layout(tok, cfg.num_clips, CAPS), lora=lora, lora_scale=SCALE,
                          device="cpu")
    return engine, tok


def _eval(inp, has_tvg, shared_prefix=True, engine=None, packed=True):
    """The evaluation of the shared inputs (CPN on) -> ({t2v, v2t}, engine);
    packed=False is the rectangle schedule, its priors RECT_PRIOR_BATCH
    captions a step."""
    if engine is None:
        engine, tok = _engine(inp, has_tvg)
        if not packed:
            engine.prior_batch = RECT_PRIOR_BATCH
    else:
        tok = ByteFallbackTokenizer()
    e = inp["eval"]
    t2v, v2t = teval.evaluation(
        engine, teval.EvalInputs(CAPTIONS, np.arange(N), e["feats"], e["t2v"], e["v2t"]), tok,
        "MSRVTT", topk=TOPK, cpn=True, has_tvg=has_tvg, verbose=False,
        shared_prefix=shared_prefix, packed=packed)
    return {"t2v": t2v, "v2t": v2t}, engine


def _train_cfg(accum=1):
    return ttrain.TrainConfig(lr=1e-3, warmup_epochs=0.0, epochs=3, weight_decay=1.0,
                              accum_iter=accum, lora=LoraConfig(dropout=0.0))


def _train_case(inp, case, rank, n_steps=2):
    """DP steps on this rank's half of the case's batch -> the averaged
    gradients of the first step, the trees after each step, and the
    all-reduces each step made."""
    t = inp["train"]
    cfg = tiny_model_config(vocab_size=152064, num_clips=4)
    tok = ByteFallbackTokenizer()
    vtg = make_vtg_layout(tok, "MSRVTT", cfg.video_tokens_vtg, 32)
    tvg = make_tvg_layout(tok, cfg.num_clips, 32)
    frozen = convert.params_from_numpy(inp["params"], torch.float32, "cpu")
    trainable = convert.trainable_from_numpy(
        t["trainable"] if rank == 0 else t["trainable_other"], "cpu")
    state = ttrain.init_train_state(trainable, _train_cfg(), steps_per_epoch=SPE)
    step = ttrain.make_train_step(cfg, _train_cfg(), vtg, tvg, device="cpu")
    half = {k: v[2 * rank: 2 * rank + 2] for k, v in t["batches"][case].items()}
    grads, trees, reduces = [], [], []
    real = ttrain.average_gradients

    def spy(leaves):
        real(leaves)
        grads.append([p.grad.clone() for p in leaves])

    ttrain.average_gradients = spy
    try:
        for _ in range(n_steps):
            before = dist.calls["all_reduce"]
            state, _ = step(state, frozen, half, torch.from_numpy(t["vocab"]))
            reduces.append(dist.calls["all_reduce"] - before)
            trees.append(convert.params_to_numpy(state.trainable))
    finally:
        ttrain.average_gradients = real
    return {"grads": [g.numpy() for g in grads[0]], "trees": trees, "reduces": reduces}


def _accum_case(inp, rank):
    """accum_iter 2: the all-reduces made by each of 2 micro-steps."""
    t = inp["train"]
    cfg = tiny_model_config(vocab_size=152064, num_clips=4)
    tok = ByteFallbackTokenizer()
    vtg = make_vtg_layout(tok, "MSRVTT", cfg.video_tokens_vtg, 32)
    tvg = make_tvg_layout(tok, cfg.num_clips, 32)
    frozen = convert.params_from_numpy(inp["params"], torch.float32, "cpu")
    state = ttrain.init_train_state(convert.trainable_from_numpy(t["trainable"], "cpu"),
                                    _train_cfg(accum=2), steps_per_epoch=SPE)
    step = ttrain.make_train_step(cfg, _train_cfg(accum=2), vtg, tvg, device="cpu")
    half = {k: v[2 * rank: 2 * rank + 2] for k, v in t["batches"]["equal"].items()}
    reduces = []
    for _ in range(2):
        before = dist.calls["all_reduce"]
        state, _ = step(state, frozen, half, torch.from_numpy(t["vocab"]))
        reduces.append(dist.calls["all_reduce"] - before)
    return {"reduces": reduces, "applied": state.applied}


def _meters(rank):
    sv = SmoothedValue()
    for v in range(rank + 1):
        sv.update(float(v + 10 * rank), n=rank + 1)
    logger = MetricLogger()
    logger.update(loss=1.0 + rank, lr=0.5)
    logger.update(loss=3.0 * rank)
    sv.synchronize_between_processes()
    logger.synchronize_between_processes()
    dist.barrier()
    return {"sv": (sv.count, sv.total), "logger": {k: (m.count, m.total, m.global_avg)
                                                   for k, m in logger.meters.items()},
            "mean": dist.all_reduce_mean(float(rank) + 0.25)}


def _cli_run(argv):
    from blim_tpu_torch.pipelines import main as tmain

    args = argparse.ArgumentParser(parents=[tmain.get_args_parser()]).parse_args(
        argv + ["--device", "cpu"])
    print_ = builtins.print
    try:
        return tmain.main(args)
    finally:
        builtins.print = print_


def _cli_common(root, out):
    return ["--tiny", "--dataset", "MSRVTT", "--data_root", str(root), "--scores_dir",
            str(os.path.join(root, "scores")), "--output_dir", str(out), "--topk", str(TOPK),
            "--cpn", "--max_caption_tokens", str(CAPS), "--alpha", "0.0", "0.8", "--c", "1.0",
            "0.5", "0.8", "0.6", "--model_path", str(os.path.join(root, "none"))]


def _cli(inp, rank):
    """pipelines.main three times under the group, recording which rank
    writes checkpoint files."""
    from blim_tpu_torch.checkpoints import state_io

    root, out = inp["cli_root"], inp["cli_out"]
    writes = []
    real = state_io.safetensors_io.save_file

    def save_file(tensors, path, *a, **k):
        writes.append(path)
        return real(tensors, path, *a, **k)

    state_io.safetensors_io.save_file = save_file
    try:
        zeroshot = _cli_run(["--eval", *_cli_common(root, os.path.join(out, "eval"))])
        train = _cli_run(["--epochs", "1", "--batch_size", "4", "--lr", "1e-3",
                          *_cli_common(root, os.path.join(out, "train"))])
        resumed = _cli_run(["--eval", "--resume",
                            os.path.join(out, "train", "checkpoint_best"),
                            *_cli_common(root, os.path.join(out, "resumed"))])
    finally:
        state_io.safetensors_io.save_file = real
    return {"zeroshot": zeroshot, "train": train, "resumed": resumed, "writes": writes}


def _dp_worker(rank, out_dir):
    """The main spawn: world checks, the sharded evaluations, the DP train
    step, the meters and the CLI."""
    inp = _inputs(out_dir)
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": dist.backend(), "meters": _meters(rank)}
    for flow, has_tvg in FLOWS.items():
        dist.calls.clear()
        mats, engine = _eval(inp, has_tvg)
        out[flow] = {"mats": mats, "shards": engine.pack_shards,
                     "prefix_forwards": engine.prefix_forwards,
                     "all_reduce": dist.calls["all_reduce"]}
    out["rect"] = {}
    for flow, has_tvg in FLOWS.items():
        dist.calls.clear()
        mats, engine = _eval(inp, has_tvg, packed=False)
        out["rect"][flow] = {"mats": mats, "shards": engine.pack_shards,
                             "all_reduce": dist.calls["all_reduce"]}
    out["train"] = {case: _train_case(inp, case, rank) for case in TRAIN_CAPTIONS}
    out["accum"] = _accum_case(inp, rank)
    out["cli"] = _cli(inp, rank)
    return out


def _fault_worker(rank, out_dir):
    """Rank 1 skips its merge of the zero-shot evaluation's VTG pass."""
    inp = _inputs(out_dir)
    engine, _ = _engine(inp, False)
    if rank == 1:
        engine._allreduce_scores = lambda scores: scores
    try:
        mats, _ = _eval(inp, False, engine=engine)
        return {"mats": mats, "error": None}
    except Exception as e:   # the planted fault must surface here on rank 0
        return {"mats": None, "error": f"{type(e).__name__}: {e}"}


# ---------------------------------------------------------------------------
# the parent: inputs, references, the one-process runs
# ---------------------------------------------------------------------------

def _write_data_root(root):
    """MSRVTT-shaped root (as tests/test_torch_cli.py's): 8 test items over
    8 videos, 8 train items of which one has no features, fp16 features,
    zero-shot and fine-tuned score matrices with the true pair ahead."""
    ds = root / "MSRVTT"
    (ds / "features").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(N):
        np.save(ds / "features" / f"video{i}.npy",
                (rng.standard_normal((4, 64, 32)) * 0.5).astype(np.float16))

    def caption():
        return " " + " ".join(rng.choice(WORDS, size=rng.integers(3, 9))) + " "

    test = [{"video": f"video{i}.mp4", "caption": caption()} for i in range(N)]
    train = [{"video": f"video{i % 7}.mp4", "caption": caption()} for i in range(7)]
    train.append({"video": "video99.mp4", "caption": caption()})
    for split, annos in (("test", test), ("train", train)):
        (ds / tdatasets.ANNOTATION_FILES["MSRVTT"][split]).write_text(json.dumps(annos))
    (root / "scores").mkdir()
    for stem in ("msrvtt", "msrvtt_zeroshot"):
        t2v, v2t = (rng.standard_normal((N, N)).astype(np.float32) + 0.01
                    + 2.0 * np.eye(N, dtype=np.float32) for _ in range(2))
        np.savez(root / "scores" / f"{stem}.npz", t2v=t2v, v2t=v2t)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def dp(tmp_path_factory, tokenizer):
    import jax
    import jax.numpy as jnp

    from blim_tpu.adapters import lora as jlora
    from blim_tpu.core.config import tiny_model_config as jax_tiny_config
    from blim_tpu.core.mesh import make_mesh
    from blim_tpu.data.collate import collate_train_batch as jax_collate
    from blim_tpu.data.prompts import make_tvg_layout as jax_tvg_layout
    from blim_tpu.data.prompts import make_vtg_layout as jax_vtg_layout
    from blim_tpu.engine import evaluation as jeval
    from blim_tpu.engine import train as jtrain
    from blim_tpu.engine.rerank import RerankEngine as JaxRerankEngine
    from blim_tpu.models import videochat_flash as jvcf
    from test_torch_tvg import _lora_numpy

    tmp = tmp_path_factory.mktemp("dp")
    jcfg = jax_tiny_config(vocab_size=152064, num_clips=4)
    jp = jvcf.init_params(jcfg, jax.random.key(0))
    params_np = jax.tree_util.tree_map(np.asarray, jp)
    lora_np = _lora_numpy(jcfg, 5)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal(
        (N, jcfg.num_clips, jcfg.tokens_per_clip, jcfg.mm_hidden_size)).astype(np.float32) * 0.5
    ev = {"feats": feats, "t2v": rng.standard_normal((N, N)).astype(np.float32) + 0.1,
          "v2t": rng.standard_normal((N, N)).astype(np.float32) + 0.1}

    # the train cases: the JAX collation of each batch of 4, B made non-zero
    vtg_j = jax_vtg_layout(tokenizer, "MSRVTT", jcfg.video_tokens_vtg, max_caption_tokens=32)
    tvg_j = jax_tvg_layout(tokenizer, jcfg.num_clips, max_caption_tokens=32)
    tfeats = rng.standard_normal(
        (4, jcfg.num_clips, jcfg.tokens_per_clip, jcfg.mm_hidden_size)).astype(np.float32) * 0.5
    batches = {case: jax_collate(caps, tfeats, np.arange(4), tokenizer, "MSRVTT", vtg_j, tvg_j)
               for case, caps in TRAIN_CAPTIONS.items()}
    jtcfg = jtrain.TrainConfig(lr=1e-3, warmup_epochs=0.0, epochs=3, weight_decay=1.0,
                               lora=jlora.LoraConfig(dropout=0.0))
    trainable = jax.tree_util.tree_map(np.array, jtrain.init_trainable(
        jax.random.key(2), jcfg, jtcfg,
        visual_head=jnp.zeros((jcfg.llm.hidden_size, jcfg.mm_hidden_size)) + 0.02))
    noise = np.random.default_rng(3)
    for name, leaf in _flat(trainable).items():   # B non-zero, so A gets a gradient
        if name.endswith("/b"):
            leaf[...] = noise.standard_normal(leaf.shape).astype(np.float32) * 0.05
    trainable["visual_head"]["kernel"] = (
        noise.standard_normal(trainable["visual_head"]["kernel"].shape).astype(np.float32) * 0.05)
    # rank 1 starts from another tree: the broadcast must replace it with rank 0's
    other = jax.tree_util.tree_map(lambda a: a + 1.0, trainable)
    vocab = tfeats.mean(axis=-2)

    cli_root = tmp / "cli"
    _write_data_root(cli_root)
    inp = {"params": params_np, "lora": lora_np, "eval": ev,
           "train": {"batches": batches, "trainable": trainable, "trainable_other": other,
                     "vocab": vocab},
           "cli_root": str(cli_root), "cli_out": str(tmp / "cli_dp")}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    (tmp / "main").mkdir()
    (tmp / "fault").mkdir()
    ranks = Ranks(_dp_worker, tmp / "main")
    fault = Ranks(_fault_worker, tmp / "fault", group_timeout=FAULT_GROUP_TIMEOUT_S)
    try:
        # the JAX references, while the ranks run
        jvtg = jax_vtg_layout(tokenizer, "MSRVTT", jcfg.video_tokens_vtg, CAPS)
        jtvg = jax_tvg_layout(tokenizer, jcfg.num_clips, CAPS)
        mesh = make_mesh(devices=jax.devices()[:1])
        jax_mats, jax_rect = {}, {}
        for flow, has_tvg in FLOWS.items():
            for packed, store in ((True, jax_mats), (False, jax_rect)):
                jengine = JaxRerankEngine(
                    jp, jcfg, jvtg, jtvg, mesh,
                    lora=jax.tree_util.tree_map(jnp.asarray, lora_np) if has_tvg else None,
                    lora_scale=SCALE, prior_batch=64 if packed else RECT_PRIOR_BATCH)
                t2v, v2t = jeval.evaluation(
                    jengine, jeval.EvalInputs(CAPTIONS, np.arange(N), feats, ev["t2v"],
                                              ev["v2t"]),
                    tokenizer, "MSRVTT", topk=TOPK, cpn=True, has_tvg=has_tvg, verbose=False,
                    packed=packed)
                store[flow] = {"t2v": t2v, "v2t": v2t}

        jvg = (vtg_j.video_start, *vtg_j.label_window)
        jtg = (tvg_j.video_start, int(tvg_j.gather_positions[0]))
        jtrainable = jax.tree_util.tree_map(jnp.asarray, trainable)

        grad_fn = jax.jit(jax.grad(lambda tr, frozen, batch: jtrain.loss_fn(
            tr, frozen, jcfg, batch, jnp.asarray(vocab), jvg, jtg, SCALE, None, 0.0)[0]))

        def grads(batch):
            g = grad_fn(jtrainable, jp, {k: jnp.asarray(v) for k, v in batch.items()})
            return _flat(jax.tree_util.tree_map(np.asarray, g))

        jax_train = {}
        for case, batch in batches.items():
            halves = [grads({k: v[2 * r: 2 * r + 2] for k, v in batch.items()}) for r in (0, 1)]
            jax_train[case] = {"joined": grads(batch),
                               "halves_mean": {k: (halves[0][k] + halves[1][k]) / 2
                                               for k in halves[0]}}
        tx = jtrain.make_optimizer(jtcfg, steps_per_epoch=SPE)
        state = jtrain.TrainState(jnp.asarray(0), jtrainable, tx.init(jtrainable))
        jstep = jtrain.make_train_step(jcfg, jtcfg, tx, vtg_j, tvg_j)
        trees = []
        for i in range(2):
            state, _ = jstep(state, jp, {k: jnp.asarray(v) for k, v in batches["equal"].items()},
                             jnp.asarray(vocab), jax.random.key(i))
            trees.append(_flat(jax.tree_util.tree_map(np.asarray, state.trainable)))
        jax_train["equal"]["trees"] = trees

        # the CLI in one process
        one = {"zeroshot": _cli_run(["--eval", *_cli_common(cli_root, tmp / "cli_one")])}
        results = ranks.join()
        faults = fault.join()
        one["resumed"] = _cli_run(["--eval", "--resume",
                                   str(tmp / "cli_dp" / "train" / "checkpoint_best"),
                                   *_cli_common(cli_root, tmp / "cli_one_resumed")])
    finally:
        for group in (ranks, fault):
            for p in group.ctx.processes:
                if p.is_alive():
                    p.kill()
    return dict(ranks=results, faults=faults, jax=jax_mats, jax_rect=jax_rect,
                jax_train=jax_train, one=one, tmp=tmp)


# ---------------------------------------------------------------------------
# world 1 and the copies
# ---------------------------------------------------------------------------

def test_world_of_one_without_a_launcher(monkeypatch):
    for k in dist.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    print_ = builtins.print
    try:
        dist.init_distributed_mode(device="cpu")
    finally:
        builtins.print = print_
    assert not tdist.is_initialized() and not dist.launched()
    assert (dist.get_rank(), dist.get_world_size(), dist.is_main_process()) == (0, 1, True)
    assert dist.backend() is None
    dist.calls.clear()
    x = np.arange(3, dtype=np.float32)
    assert dist.all_reduce_sum(x) is x
    t = torch.ones(3)
    assert dist.all_reduce_sum_(t) is t and dist.all_reduce_mean(2.5) == 2.5
    dist.broadcast_([t])
    dist.barrier()
    assert not dist.calls
    assert dist.process_shard_bounds(17, 1, 0) == (0, 17)


def test_device_for_rank(monkeypatch):
    assert dist.device_for_rank("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            dist.device_for_rank("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert dist.device_for_rank("cuda") == torch.device("cuda", 1)
    assert dist.device_for_rank("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="one rank per card"):
        dist.device_for_rank("cuda")
    # under a launcher an explicit index must be the rank's own card
    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", MASTER_ADDR="localhost",
                     MASTER_PORT="29500").items():
        monkeypatch.setenv(k, v)
    assert dist.launched()
    assert dist.device_for_rank("cuda:1") == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1"):
        dist.device_for_rank("cuda:0")
    monkeypatch.setenv("LOCAL_RANK", "0")        # ranks sharing a card on purpose
    assert dist.device_for_rank("cuda:0") == torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# the sharded evaluation at world 2
# ---------------------------------------------------------------------------

def test_ranks_form_a_gloo_group_of_two(dp):
    for r, out in enumerate(dp["ranks"]):
        assert (out["rank"], out["world"], out["backend"]) == (r, WORLD, "gloo")


@pytest.mark.parametrize("flow,direction,name", CELLS, ids=CELL_IDS)
def test_sharded_matrices_match_jax_on_every_rank(dp, flow, direction, name):
    j = dp["jax"][flow][direction][name]
    for out in dp["ranks"]:
        t = out[flow]["mats"][direction][name]
        assert t.shape == j.shape == (N, N)
        np.testing.assert_array_equal(t == -100.0, j == -100.0)
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("flow", list(FLOWS))
def test_sharded_matrices_identical_across_ranks(dp, flow):
    a, b = (out[flow]["mats"] for out in dp["ranks"])
    for direction in ("t2v", "v2t"):
        assert a[direction].keys() == b[direction].keys()
        for name in a[direction]:
            np.testing.assert_array_equal(a[direction][name], b[direction][name])


@pytest.mark.parametrize("flow", list(FLOWS))
def test_pack_shards_are_disjoint_and_cover_every_bucket(dp, flow):
    shards = [out[flow]["shards"] for out in dp["ranks"]]
    assert len(shards[0]) == len(shards[1]) > 0
    passes = set()
    for (n0, b0, lo0, hi0, m0), (n1, b1, lo1, hi1, m1) in zip(*shards):
        assert (n0, b0, m0) == (n1, b1, m1)
        assert (lo0, hi0, lo1, hi1) == (0, min(m0, m0 // 2 + 1), hi0, m0)
        passes.add(n0)
    assert passes == ({"vtg", "tvg", "tvg_prior"} if FLOWS[flow] else {"vtg"})
    if FLOWS[flow]:   # the TVG prior classes hold one pack each: rank 1's shard is empty
        assert any(lo == hi for _, _, lo, hi, _ in shards[1])
    # ... and rank 1 still joined every merge
    merges = 1 + 2 * FLOWS[flow]
    assert [out[flow]["all_reduce"] for out in dp["ranks"]] == [merges, merges]
    scored = [sum(hi - lo for _, _, lo, hi, _ in s) for s in shards]
    assert sum(scored) == sum(m for _, _, _, _, m in shards[0]) and min(scored) > 0


@pytest.mark.parametrize("flow,direction,name", CELLS, ids=CELL_IDS)
def test_sharded_rectangle_matches_jax_on_every_rank(dp, flow, direction, name):
    j = dp["jax_rect"][flow][direction][name]
    for out in dp["ranks"]:
        t = out["rect"][flow]["mats"][direction][name]
        assert t.shape == j.shape == (N, N)
        np.testing.assert_array_equal(t == -100.0, j == -100.0)
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("flow", list(FLOWS))
def test_sharded_rectangle_identical_across_ranks(dp, flow):
    a, b = (out["rect"][flow]["mats"] for out in dp["ranks"])
    for direction in ("t2v", "v2t"):
        assert a[direction].keys() == b[direction].keys()
        for name in a[direction]:
            np.testing.assert_array_equal(a[direction][name], b[direction][name])


@pytest.mark.parametrize("flow", list(FLOWS))
def test_rectangle_shards_are_disjoint_and_cover_every_bucket(dp, flow):
    """Each k-bucket of the rectangle's groups is split between the ranks:
    rank 0 takes [0, m // 2 + 1), rank 1 the rest; the VTG prior pass is not
    sharded. Both ranks join each merge: VTG, and TVG scores and priors."""
    shards = [out["rect"][flow]["shards"] for out in dp["ranks"]]
    assert len(shards[0]) == len(shards[1]) > 0
    passes = set()
    for (n0, k0, lo0, hi0, m0), (n1, k1, lo1, hi1, m1) in zip(*shards):
        assert (n0, k0, m0) == (n1, k1, m1)
        assert (lo0, hi0, lo1, hi1) == (0, min(m0, m0 // 2 + 1), hi0, m0)
        passes.add(n0)
    assert passes == ({"vtg_shared", "tvg_shared"} if FLOWS[flow] else {"vtg_shared"})
    merges = 1 + 2 * FLOWS[flow]
    assert [out["rect"][flow]["all_reduce"] for out in dp["ranks"]] == [merges, merges]
    scored = [sum(hi - lo for _, _, lo, hi, _ in s) for s in shards]
    assert sum(scored) == sum(m for _, _, _, _, m in shards[0]) and min(scored) > 0


def test_planted_skipped_merge_is_caught(dp):
    r0, r1 = dp["faults"]
    assert r0["error"] is not None and r0["mats"] is None
    j = dp["jax"]["zeroshot"]["v2t"]["candidate_likelihood"]
    t = r1["mats"]["v2t"]["candidate_likelihood"]
    assert not np.allclose(t, j, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# the data-parallel train step at world 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(TRAIN_CAPTIONS))
def test_dp_trees_identical_across_ranks(dp, case):
    a, b = (out["train"][case] for out in dp["ranks"])
    assert a["reduces"] == b["reduces"] == [1, 1]
    for ta, tb in zip(a["trees"], b["trees"]):
        fa, fb = _flat(ta), _flat(tb)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _grad_close(got, want, leaf):
    g, w = got, want
    np.testing.assert_allclose(g, w, atol=GRAD_REL * max(np.abs(w).max(), 1e-30), rtol=0,
                               err_msg=leaf)


def _rank_grads(dp, case):
    names = list(_flat(dp["ranks"][0]["train"][case]["trees"][0]).keys())
    return dict(zip(names, dp["ranks"][0]["train"][case]["grads"]))


def test_dp_equal_label_counts_match_the_joined_batch(dp):
    got = _rank_grads(dp, "equal")
    want = dp["jax_train"]["equal"]["joined"]
    assert got.keys() == want.keys()
    for leaf in want:
        _grad_close(got[leaf], want[leaf], leaf)
    for i, jtree in enumerate(dp["jax_train"]["equal"]["trees"]):
        ttree = _flat(dp["ranks"][1]["train"]["equal"]["trees"][i])
        for leaf in jtree:
            np.testing.assert_allclose(ttree[leaf], jtree[leaf], atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL, err_msg=leaf)


def test_dp_unequal_label_counts_average_the_halves(dp):
    """DDP semantics: the mean of the halves' gradients, which is not the
    joined batch's gradient when the halves carry different label counts."""
    got = _rank_grads(dp, "unequal")
    ref = dp["jax_train"]["unequal"]
    for leaf in ref["halves_mean"]:
        _grad_close(got[leaf], ref["halves_mean"][leaf], leaf)
    gap = max(np.abs(ref["halves_mean"][k] - ref["joined"][k]).max() / np.abs(ref["joined"][k]).max()
              for k in ref["joined"] if np.abs(ref["joined"][k]).max() > 0)
    assert gap > 100 * GRAD_REL


def test_dp_accumulation_makes_one_all_reduce(dp):
    for out in dp["ranks"]:
        assert out["accum"] == {"reduces": [0, 1], "applied": 1}


# ---------------------------------------------------------------------------
# meters, the CLI
# ---------------------------------------------------------------------------

def test_meters_sum_over_ranks(dp):
    # rank 0: one value 0 with n 1; rank 1: values 10, 11 with n 2
    want_sv = (1 + 4, 0.0 + 2 * (10.0 + 11.0))
    for out in dp["ranks"]:
        m = out["meters"]
        assert m["sv"] == want_sv
        assert m["logger"]["loss"][:2] == (4, 1.0 + 0.0 + 2.0 + 3.0)
        assert m["logger"]["lr"][:2] == (2, 1.0)
        assert m["mean"] == pytest.approx(0.75)


def test_cli_under_two_ranks_only_rank_zero_writes(dp):
    w0, w1 = (out["cli"]["writes"] for out in dp["ranks"])
    assert w1 == [] and len(w0) == 2     # epoch0/ and checkpoint_best/
    out = dp["tmp"] / "cli_dp"
    from blim_tpu_torch.engine import loop as tloop

    log = (out / "eval" / "log.txt").read_text()
    table = tloop.results_table(dp["ranks"][0]["cli"]["zeroshot"])
    assert log.count(table) == 1
    lines = (out / "train" / "log.txt").read_text().splitlines()
    assert sum(line.startswith("{") for line in lines) == 1
    assert {p.name for p in (out / "train").iterdir()} == {"epoch0", "checkpoint_best", "log.txt"}


def test_cli_under_two_ranks_matches_one_process(dp):
    a, b = (out["cli"] for out in dp["ranks"])
    for key in ("zeroshot", "train", "resumed"):
        assert a[key] == b[key], key
    assert a["zeroshot"] == dp["one"]["zeroshot"]
    assert a["resumed"] == a["train"] == dp["one"]["resumed"]
    assert a["resumed"] != a["zeroshot"]
