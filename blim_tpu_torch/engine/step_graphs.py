"""CUDA graphs of the rerank engine's packed steps, kept with the weights.

A packed step (engine/rerank.py: one VTG, VTG prior, TVG or TVG prior step
of one pack size, query bucket and batch) enqueues thousands of device
operations, and the host takes longer to enqueue them one by one than the
card takes to run them. On CUDA each step shape is captured once into a
`torch.cuda.CUDAGraph` and replayed from then on; on the CPU the steps run
as they are.

Everything a graph reads lives at an address that does not move:
  * the weights (params and the LoRA tree). The graphs belong to them: a
    weak dictionary keyed on the embedding table holds them, so they die
    with the weights, and a fingerprint of what the captured steps read as
    an address or a Python value (every params and LoRA tensor's address,
    shape, stride and dtype, `lora_scale`, the config, the layouts' lengths)
    guards them. A mismatch drops them all: `set_trainable` with a new
    tensor captures anew, while AdamW's in-place updates are read by the
    graphs as they are;
  * the pass-level operands (the feature bank, the VTG prefix, the prior
    K/V and its mask, the TVG first ids, embeddings and video vocabulary):
    buffers owned here, filled by a device-to-device copy at each pass's
    start (`bind`);
  * each step key's inputs: static tensors that the engine copies the
    batch's host rows into (`step`).

A step is captured the first time its key is seen and replayed after that
(`run`). The graphs share one memory pool (a new one whenever they are all
dropped: a pool whose graphs are gone takes no new graph), so their memory
is about that of the largest step; a graph's temporaries may then overlap another
graph's output, so each output is cloned right after its replay, which also
keeps the pass's pending scores from the key's later replays. The counters
a step moves in Python (the engine's prefix forwards, the flash-attention
launch counters) are recorded at capture and added on every replay.

A graph replays the code that ran when it was captured: code patched later
(a planted fault) runs only after `drop(params)`. Inside `eager()` the
steps run eagerly on CUDA too, and the graphs kept stay as they are: a
profiler then ties each kernel to the span that launched it, which it
cannot do inside a replayed graph.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from blim_tpu_torch.kernels import flash_attention as fa
from blim_tpu_torch.utils.profiling import span

# the engine's counters a step moves in Python
ENGINE_COUNTERS = ("prefix_forwards", "tvg_prefix_forwards")

# the embedding table -> its weights' StepGraphs
_CACHES = WeakIdKeyDictionary()
# open `eager()` scopes
_eager = 0


class CudaStepGraph:
    """One step in a torch.cuda.CUDAGraph, captured on a side stream into a
    memory pool shared with the other steps' graphs."""

    def __init__(self, pool, stream: torch.cuda.Stream):
        self.graph = torch.cuda.CUDAGraph()
        self.pool, self.stream = pool, stream

    def capture(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        """Record fn's device work (nothing runs) -> its static output."""
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            # thread-local: another thread's CUDA calls (an NCCL watchdog)
            # do not break the capture
            self.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass                    # the capture fn broke; raise fn's error
                raise
            self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(self.stream)
        return out

    def replay(self) -> None:
        self.graph.replay()


def graph_maker(device: torch.device) -> Optional[Callable[[], Any]]:
    """A maker of step graphs sharing one memory pool and capture stream on
    `device`, or None where the packed steps run eagerly (off CUDA)."""
    if device.type != "cuda":
        return None
    pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)
    return lambda: CudaStepGraph(pool, stream)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def fingerprint(engine) -> Tuple:
    """What an engine's captured steps read as an address or a Python value."""
    sig = tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                for t in _tensors({"params": engine.params, "lora": engine.lora}))
    vtg, tvg = engine.vtg_layout, engine.tvg_layout
    return (sig, engine.lora_scale, engine.config, vtg.prefix_len, vtg.video_start,
            None if tvg is None else tvg.prefix_len)


def _key(params) -> torch.Tensor:
    return params["llm"]["embed_tokens"]["embedding"]


@contextlib.contextmanager
def eager():
    """The packed steps run eagerly inside the scope, on CUDA too."""
    global _eager
    _eager += 1
    try:
        yield
    finally:
        _eager -= 1


def for_engine(engine) -> Optional["StepGraphs"]:
    """The step graphs of the engine's weights (new, or anew where the
    fingerprint changed), or None where its steps run eagerly (off CUDA,
    or inside `eager()`)."""
    if _eager:
        return None
    key = _key(engine.params)
    graphs = _CACHES.pop(key, None)
    if graphs is None or graphs.fingerprint != fingerprint(engine):
        graphs = None              # the old graphs go before the new ones capture
        new_graph = graph_maker(engine.device)
        if new_graph is None:
            return None
        graphs = StepGraphs(fingerprint(engine), engine.device, new_graph)
    _CACHES[key] = graphs
    return graphs


def drop(params) -> None:
    """Forget the step graphs of these weights (their memory goes back to
    the allocator once nothing else holds it)."""
    _CACHES.pop(_key(params), None)


@dataclasses.dataclass
class Step:
    inputs: Tuple[torch.Tensor, ...]     # static: the engine copies each batch here
    graph: Any = None
    output: Optional[torch.Tensor] = None
    engine_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_counts: Dict[str, int] = dataclasses.field(default_factory=dict)


class StepGraphs:
    def __init__(self, fp: Tuple, device: torch.device, new_graph: Callable[[], Any]):
        self.fingerprint, self.device, self.new_graph = fp, device, new_graph
        self.buffers: Dict[str, torch.Tensor] = {}
        self.steps: Dict[Tuple, Step] = {}

    def drop_steps(self) -> None:
        """Forget every step; the next captures take a new memory pool."""
        self.steps = {}
        self.new_graph = graph_maker(self.device)

    def bind(self, name: str, src: torch.Tensor) -> torch.Tensor:
        """The pass operand `name`, copied from `src` into its buffer (a new
        buffer, and every graph dropped, where its layout changed)."""
        buf = self.buffers.get(name)
        if buf is None or (buf.shape, buf.stride(), buf.dtype) != (src.shape, src.stride(),
                                                                    src.dtype):
            if buf is not None:
                self.drop_steps()
            buf = self.buffers[name] = torch.empty_like(src)
        return buf.copy_(src)

    def step(self, key: Tuple, arrays) -> Step:
        """The step of `key`, with static inputs shaped as `arrays` (host
        rows) made at first sight."""
        st = self.steps.get(key)
        if st is None:
            st = self.steps[key] = Step(tuple(
                torch.empty_like(torch.from_numpy(a), device=self.device) for a in arrays))
        return st

    def run(self, engine, st: Step, forward: Callable[[Tuple[torch.Tensor, ...]], Any]) -> Any:
        """Replay the step on its static inputs, capturing forward(inputs)
        first if the key is new -> a copy of its output (a tensor, or a
        tuple of tensors)."""
        if st.graph is None:
            with span("rerank.capture"):
                eng0, fa0 = {n: getattr(engine, n) for n in ENGINE_COUNTERS}, fa.counts()
                graph = self.new_graph()
                st.output = graph.capture(lambda: forward(st.inputs))
                st.engine_counts = {n: getattr(engine, n) - v for n, v in eng0.items()}
                st.kernel_counts = {k: v - fa0[k] for k, v in fa.counts().items() if v != fa0[k]}
                st.graph = graph
            engine.graph_captures += 1
        else:
            for n, d in st.engine_counts.items():
                setattr(engine, n, getattr(engine, n) + d)
            fa.add_counts(st.kernel_counts)
            engine.graph_replays += 1
        st.graph.replay()
        if isinstance(st.output, tuple):
            return tuple(t.clone() for t in st.output)
        return st.output.clone()
