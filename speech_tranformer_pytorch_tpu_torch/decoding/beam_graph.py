"""Beam search with each step replayed as a CUDA graph.

``beam.beam_search`` comes here for a model on a card, with the lineage
table, no mesh and nothing being exported. Issued from Python, one beam
step is some 215 kernel launches, and the host spends about twenty times
the device time they cause on issuing them; a CUDA graph issues them in
one launch. What is captured is ``beam.beam_step``, the eager search's own
step function, run with its index a 0-d int32 tensor on the card and its
state in static buffers that it updates in place: the self K/V cache is
written at the index (``index_copy_``), the rest of the carry is copied
back at the end of the step, the early-stop test is computed into a flag
on the card and the index is incremented. So one replay advances the
search by one step, and every kernel in it is the one the eager step
launches.

``StepGraphs`` holds a model's static arena: flat buffers, one for each
tensor of the search's state and caches, each sized for the largest step
shape seen so far. A step shape (batch, beam, max_len, encoder frames,
dtype, int8 cross cache, alpha) takes views of them, so one arena serves
every shape, and every capture shares one graph memory pool. A hybrid
CTC/attention search (``ctc_weight`` > 0) keeps its CTC log-probs,
valid lengths and the hypotheses' CTC states and ψ there too, and the
captured step holds the CTC prefix scorer. A call
writes its initial state and caches into its views (what the eager search
starts from, nothing left of an earlier call), then

- at a shape's first sight, runs the step eagerly on the views, and
  captures it once the call is done (an ``st.decode.capture`` span);
- afterwards replays its graph once a step and, with ``early_stop``,
  reads the flag after each replay (one host sync a step, as the eager
  loop has): the steps run are the eager loop's.

Both run in ``beam.decode_loop``, which hands each step the arena's index.

A shape larger than the arena grows it, and parameters whose storage
moved invalidate the captures: either drops every graph, and every shape
seen is captured again at the end of that call, so a caller that serves
each shape once before its traffic captures nothing later. On the CPU the
same code runs the step eagerly on the arena at every call (nothing is
captured there), which is how the tests hold it to ``eager_beam_search``.

Launch counts (``kernels/interface.launch_counts``) stay the kernels the
port ran: a capture's launches are taken back, and every replay credits
the captured step's. ``interface.decode_step_counts`` counts the captures,
replays and eager steps.
"""

from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Callable, Dict, Optional, Tuple

import torch

from ..kernels import interface
from ..models import SpeechTransformer
from ..utils.profiling import named_scope
from .beam import (BeamResult, CTCPrefix, beam_step, ctc_prepare, decode_loop, finalize,
                   initial_carry, keep_going, split_cache, stop_bound)

# name -> (shape, strides, dtype) of each tensor a step shape keeps in the arena
Spec = Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...], torch.dtype]]


@dataclasses.dataclass
class _Step:
    """One step shape on the arena: its views, the step that advances
    them in place, and its graph once captured."""
    carry: dict                  # the search's state (views), self K/V included
    index: torch.Tensor          # 0-d int32: the next step's index, advanced by it
    go: torch.Tensor             # 0-d bool: the early-stop test after the last step
    max_lp: torch.Tensor         # what the test divides by (``beam.stop_bound``)
    advance: Callable[[], None]  # one step in place: what is captured
    graph: Optional[torch.cuda.CUDAGraph] = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    def replay(self) -> None:
        """One step as a replay of the captured graph, its launches credited."""
        self.graph.replay()
        interface.credit_launches(self.launches)


class StepGraphs:
    """A model's static arena and the captured beam step of each shape
    (module docstring). One per model: ``graph_beam_search`` keeps it."""

    def __init__(self, device: torch.device):
        self.device = device
        self._buffers: Dict[Tuple[str, torch.dtype], torch.Tensor] = {}
        self._specs: Dict[tuple, Spec] = {}      # every step shape seen
        self._steps: Dict[tuple, _Step] = {}     # built on the current buffers
        self._params: tuple = ()                 # storage the graphs read
        self._pool = None
        self._stream = None

    def _take(self, name: str, shape, strides, dtype: torch.dtype) -> torch.Tensor:
        """A view of ``shape`` and ``strides`` at the start of the buffer of
        ``name``; growing the buffer drops every step built on the old one.
        The strides are the eager cache's (the int8 cross K/V keep the
        encoder's frame-major order), so that every product in the step
        reads its operands as the eager step does and computes the same
        bits."""
        n = 1 + sum((size - 1) * step for size, step in zip(shape, strides))
        buf = self._buffers.get((name, dtype))
        if buf is None or buf.numel() < n:
            self._drop_graphs()
            self._buffers.pop((name, dtype), None)   # freed before its successor
            buf = torch.empty(n, dtype=dtype, device=self.device)
            self._buffers[(name, dtype)] = buf
        return buf.as_strided(shape, strides)

    def _drop_graphs(self) -> None:
        """Forget every step built on the arena; the next captures go to a
        new pool (a pool whose graphs are all gone cannot take more)."""
        self._steps.clear()
        self._pool = None

    def _build(self, model: SpeechTransformer, key: tuple, spec: Spec) -> _Step:
        """The views of ``spec`` and the step that advances them."""
        b, k, max_len, _, _, _, alpha, ctc_weight = key
        views = {name: self._take(name, *layout) for name, layout in spec.items()}
        ctc = (CTCPrefix(views["ctc.logp"], views["ctc.lens"], ctc_weight)
               if ctc_weight > 0.0 else None)
        cache: dict = {}
        for name, view in views.items():
            if name.startswith("cache."):
                layer, tensor = name[len("cache."):].split(".")
                cache.setdefault(layer, {})[tensor] = view
        const, own = split_cache(cache)
        carry = {name[len("carry."):]: view for name, view in views.items()
                 if name.startswith("carry.")}
        carry["cache"] = own
        index, go = views["index"], views["go"]
        max_lp = stop_bound(max_len, alpha, self.device)
        # A proxy: the steps live as long as the model, and must not keep it.
        step = beam_step(weakref.proxy(model), const, views["mem_lens"], b=b, k=k,
                         max_len=max_len, alpha=alpha, use_lineage=True,
                         device=self.device, ctc=ctc)

        def advance() -> None:
            nxt = step(carry, index)
            for name, t in nxt.items():
                if name != "cache":   # the self K/V were written in place
                    carry[name].copy_(t)
            go.copy_(keep_going(carry, max_lp))
            index.add_(1)

        return _Step(carry=carry, index=index, go=go, max_lp=max_lp, advance=advance)

    def _capture(self, entry: _Step) -> None:
        """Capture one step of ``entry`` on a side stream into the shared
        pool; its launches are taken back and kept for the replays."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        before = interface.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with named_scope("st.decode.capture"):
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            # cuBLAS keeps a workspace per stream (32 MiB on Hopper). Cleared
            # around the capture, the capture stream's is allocated in the
            # graph pool and returned to it afterwards, as the pool's other
            # scratch is, rather than held beside the default stream's.
            torch._C._cuda_clearCublasWorkspaces()
            with torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    entry.advance()
                finally:
                    graph.capture_end()
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        launched = {name: n - before[name]
                    for name, n in interface.launch_counts().items() if n != before[name]}
        interface.credit_launches(launched, -1)
        interface.count_decode_steps("captures")
        entry.graph, entry.launches = graph, launched

    def search(self, model: SpeechTransformer, memory: torch.Tensor,
               mem_lens: torch.Tensor, *, beam_size: int, max_len: int, alpha: float,
               int8_kv: bool, early_stop: bool, ctc_weight: float = 0.0) -> BeamResult:
        b, k = memory.shape[0], beam_size
        params = tuple(t.data_ptr() for t in itertools.chain(model.decoder.parameters(),
                                                             model.decoder.buffers()))
        if params != self._params:
            self._drop_graphs()
            self._params = params
        key = (b, k, max_len, memory.shape[1], memory.dtype, int8_kv, float(alpha),
               float(ctc_weight))
        spec: Spec = {}

        def store(name: str, t: torch.Tensor) -> torch.Tensor:
            spec[name] = (tuple(t.shape), t.stride(), t.dtype)
            view = self._take(name, *spec[name])
            view.copy_(t)
            return view

        with named_scope("st.decode.init_cache"):
            _, own = split_cache(model.init_cache(
                memory, max_len, k, int8_kv, store=lambda name, t: store("cache." + name, t)))
            sos_state = None
            if ctc_weight > 0.0:
                logp, lens, sos_state = ctc_prepare(model, memory, mem_lens)
                store("ctc.logp", logp)
                store("ctc.lens", lens)
                del logp
            for name, t in initial_carry(b, k, max_len, self.device, own, True,
                                         sos_state).items():
                if name != "cache":
                    store("carry." + name, t)
            # int32, as the cross-attention kernel reads it: no cast in the step
            store("mem_lens", mem_lens.to(torch.int32))
            store("index", torch.zeros((), dtype=torch.int32, device=self.device))
            spec["go"] = ((), (), torch.bool)
            self._specs[key] = spec
            entry = self._steps.get(key)
            if entry is None:
                entry = self._steps[key] = self._build(model, key, spec)
            if early_stop:   # the test before the first step
                entry.go.copy_(keep_going(entry.carry, entry.max_lp))
        # A shape's first call on this arena runs its step eagerly.
        run, kind = ((entry.advance, "eager_steps") if entry.graph is None
                     else (entry.replay, "replays"))

        def step(c, i):   # i is the arena's index, which the step advances
            run()
            return c

        _, steps = decode_loop(step, entry.carry, [entry.index] * max_len, kind=kind,
                               stop=(lambda c: not bool(entry.go)) if early_stop else None)
        with named_scope("st.decode.finalize"):
            result = finalize(entry.carry, steps, alpha)
        if self.device.type == "cuda":
            self._capture_all(model)
        return result

    def _capture_all(self, model: SpeechTransformer) -> None:
        """Capture every shape seen that has no graph on the arena."""
        for key, spec in self._specs.items():
            entry = self._steps.get(key)
            if entry is None:
                entry = self._steps[key] = self._build(model, key, spec)
            if entry.graph is None:
                self._capture(entry)


_GRAPHS: "weakref.WeakKeyDictionary[SpeechTransformer, StepGraphs]" = \
    weakref.WeakKeyDictionary()


@torch.no_grad()
def graph_beam_search(model: SpeechTransformer, memory: torch.Tensor,
                      mem_lens: torch.Tensor, *, beam_size: int, max_len: int,
                      alpha: float = 1.0, int8_kv: bool = False,
                      early_stop: bool = True, ctc_weight: float = 0.0) -> BeamResult:
    """``beam.eager_beam_search`` with the lineage table, on the model's
    static arena (``StepGraphs``, made at the model's first call and
    dropped with it): on a card each step is a CUDA graph replay after a
    shape's first call; on the CPU every step runs eagerly."""
    graphs = _GRAPHS.get(model)
    if graphs is None or graphs.device != memory.device:
        graphs = _GRAPHS[model] = StepGraphs(memory.device)
    return graphs.search(model, memory, mem_lens, beam_size=beam_size, max_len=max_len,
                         alpha=alpha, int8_kv=int8_kv, early_stop=early_stop,
                         ctc_weight=ctc_weight)
