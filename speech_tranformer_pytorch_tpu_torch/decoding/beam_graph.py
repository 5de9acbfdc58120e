"""Beam search with each step, and each served call's prologue, replayed
as CUDA graphs.

``beam.beam_search`` comes here for a model on a card, with the lineage
table, no mesh and nothing being exported, and ``recognize.Recognizer``
comes to ``graph_beam_decode`` under the same conditions with a call's
int16 PCM. Launched from Python, one beam step is some 215 kernels, and
the host spends about twenty times the device time they cause on
launching them; a CUDA graph launches them all at once. What is captured is
``beam.beam_step``, the eager search's own step function, run with its
index a 0-d int32 tensor on the card and its state in static buffers that
it updates in place: the self K/V cache is written at the index (by the
lineage kernel, ``interface.lineage_attention_step``), the rest of the
carry is copied back at the end of the step, the early-stop test is
computed into a flag on the card and the index is incremented. So one
replay advances the search by one step, and every kernel in it is the one
the eager step launches.

A served call's prologue is its work before the first step: the features
(``data/features.extract_features``), the encoder (``beam.encode_on``),
the decoder's caches (``Decoder.init_cache``), with a CTC weight the CTC
head's log-probs (``beam.ctc_prepare``), the initial state
(``beam.initial_carry``), with a forced prompt its rows (``beam.read_prompt``)
and the first early-stop test: some 180 to 260
launches a call for a few milliseconds of device work. ``graph_beam_decode``
copies the call's PCM and sample lengths into static views of the arena
(``pcm``, ``pcm.lens``, in the caller's dtypes) and runs the prologue on
them, writing each of its outputs into the step's views, so that it too is
captured once a call shape (``_Call``) and replayed as one launch.

``StepGraphs`` holds a model's static arena: flat buffers, one for each
tensor of the search's state and caches and for the call's inputs, each
sized for the largest shape seen so far. A step shape (batch, beam,
max_len, encoder frames, dtype, int8 cross cache, alpha, CTC weight) takes
views of them, so one arena serves every shape, and every capture shares
one graph memory pool. A forced prompt (``beam.Prompt``) is part of both
shapes: its tokens are fed as decode steps in the prologue, and the
search's steps start at the prompt's cache position. A hybrid CTC/attention search (``ctc_weight`` > 0)
keeps its CTC log-probs, valid lengths and the hypotheses' CTC states and
ψ there too, and the captured step holds the CTC prefix scorer. A call
writes its initial state and caches into its views (what the eager search
starts from, nothing left of an earlier call), then

- at a shape's first sight, runs the step (and its prologue) eagerly on
  the views, and captures them once the call is done (``st.decode.capture``
  spans);
- afterwards replays the prologue's graph once (an ``st.decode.prologue``
  span) and the step's once a step and, with ``early_stop``, reads the
  flag after each step's replay (one host sync a step, as the eager loop
  has): the steps run are the eager loop's.

The steps run in ``beam.decode_loop``, which hands each step the arena's
index. The prologue and step graphs share the pool and replay in another
order than they were captured, so no graph reads what another left in
it: every output of a prologue goes to the arena, which is allocated
outside the pool, and whatever a capture allocates in the pool is scratch
freed before the capture ends.

A shape larger than the arena grows it, and parameters or buffers of the
model whose storage moved invalidate the captures: either drops every
graph, and every shape seen is captured again at the end of that call, so
a caller that serves each shape once before its traffic captures nothing
later. On the CPU the same code runs the prologue and the step eagerly on
the arena at every call (nothing is captured there), which is how the
tests hold it to ``eager_beam_search`` and to the Recognizer's eager route.

Launch counts (``kernels/interface.launch_counts``) stay the kernels the
port ran, and row-write counts (``interface.row_write_counts``) the self
K/V rows it wrote: a capture's are taken back, and every replay credits
the captured graph's. ``interface.decode_step_counts`` counts the step
captures, replays and eager steps, and the prologues captured, replayed
and run eagerly.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import weakref
from typing import Callable, Dict, Optional, Tuple

import torch

from ..config import FeatureConfig
from ..data.features import extract_features
from ..kernels import interface
from ..models import SpeechTransformer
from ..utils.profiling import named_scope
from .beam import (BeamResult, CTCPrefix, Prompt, beam_step, check_ctc_search,
                   check_prompt_search, ctc_prepare, decode_loop, encode_on, finalize,
                   initial_carry, keep_going, read_prompt, split_cache, stop_bound)

# name -> (shape, strides, dtype) of each tensor a step shape keeps in the arena
Spec = Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...], torch.dtype]]


@dataclasses.dataclass
class _Graph:
    """A captured CUDA graph and the launches and row writes its capture
    took back."""
    graph: torch.cuda.CUDAGraph
    launches: Dict[str, int]
    row_writes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def replay(self) -> None:
        """One replay, its launches and row writes credited."""
        self.graph.replay()
        interface.credit_launches(self.launches)
        interface.credit_row_writes(self.row_writes)


@dataclasses.dataclass
class _Step:
    """One step shape on the arena: its views, the step that advances
    them in place, and its graph once captured."""
    key: tuple                   # the step shape (``StepGraphs._start``)
    views: Dict[str, torch.Tensor]   # every tensor of the shape, by spec name
    carry: dict                  # the search's state (views), self K/V included
    index: torch.Tensor          # 0-d int32: the next step's index, advanced by it
    go: torch.Tensor             # 0-d bool: the early-stop test after the last step
    max_lp: torch.Tensor         # what the test divides by (``beam.stop_bound``)
    advance: Callable[[], None]  # one step in place: what is captured
    graph: Optional[_Graph] = None


@dataclasses.dataclass(frozen=True)
class _Call:
    """A call shape of ``graph_beam_decode``: what one prologue graph is
    captured for. The padded PCM length fixes the feature and encoder
    lengths, so the call shape fixes the step shape."""
    audio: Tuple[int, int]       # [B, S] padded PCM
    audio_dtype: torch.dtype
    lens_dtype: torch.dtype
    features: FeatureConfig
    beam_size: int
    max_len: int
    alpha: float
    int8_kv: bool
    ctc_weight: float
    prompt: Optional[Prompt]


class StepGraphs:
    """A model's static arena, the captured beam step of each step shape
    and the captured prologue of each call shape (module docstring). One
    per model: ``graph_beam_search`` and ``graph_beam_decode`` keep it."""

    def __init__(self, device: torch.device):
        self.device = device
        self._buffers: Dict[Tuple[str, torch.dtype], torch.Tensor] = {}
        self._specs: Dict[tuple, Spec] = {}        # every step shape seen
        self._calls: Dict[_Call, tuple] = {}       # every call shape seen: its step shape
        self._steps: Dict[tuple, _Step] = {}       # built on the current buffers
        self._prologues: Dict[_Call, _Graph] = {}  # captured on the current buffers
        self._params: tuple = ()                   # storage the graphs read
        self._pool = None
        self._stream = None

    def _take(self, name: str, shape, strides, dtype: torch.dtype) -> torch.Tensor:
        """A view of ``shape`` and ``strides`` at the start of the buffer of
        ``name``; growing the buffer drops every graph built on the old one.
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
        """Forget every step and prologue built on the arena; the next
        captures go to a new pool (a pool whose graphs are all gone cannot
        take more)."""
        self._steps.clear()
        self._prologues.clear()
        self._pool = None

    def _check_params(self, model: SpeechTransformer) -> None:
        """Drop every graph if a parameter or buffer of ``model`` has moved:
        the prologues read the encoder and the CTC head, the steps the
        decoder."""
        params = tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                             model.buffers()))
        if params != self._params:
            self._drop_graphs()
            self._params = params

    def _build(self, model: SpeechTransformer, key: tuple) -> _Step:
        """The views of step shape ``key`` and the step that advances them."""
        b, k, max_len, _, _, _, alpha, ctc_weight, prompt = key
        views = {name: self._take(name, *layout) for name, layout in self._specs[key].items()}
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
                         device=self.device, ctc=ctc, prompt=prompt)

        def advance() -> None:
            nxt = step(carry, index)
            for name, t in nxt.items():
                if name != "cache":   # the self K/V were written in place
                    carry[name].copy_(t)
            go.copy_(keep_going(carry, max_lp))
            index.add_(1)

        return _Step(key=key, views=views, carry=carry, index=index, go=go, max_lp=max_lp,
                     advance=advance)

    def _entry(self, model: SpeechTransformer, key: tuple) -> _Step:
        """The step of shape ``key`` on the current buffers, built if need be."""
        entry = self._steps.get(key)
        if entry is None:
            entry = self._steps[key] = self._build(model, key)
        return entry

    def _capture(self, fn: Callable[[], object]) -> _Graph:
        """Capture ``fn`` on a side stream into the shared pool; its
        launches and row writes are taken back and kept for the replays."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        before, rows_before = interface.launch_counts(), interface.row_write_counts()
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
                    fn()
                finally:
                    graph.capture_end()
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        launched = {name: n - before[name]
                    for name, n in interface.launch_counts().items() if n != before[name]}
        interface.credit_launches(launched, -1)
        rows = {route: n - rows_before[route]
                for route, n in interface.row_write_counts().items()
                if n != rows_before[route]}
        interface.credit_row_writes(rows, -1)
        return _Graph(graph, launched, rows)

    def _start(self, model: SpeechTransformer, memory: torch.Tensor, mem_lens: torch.Tensor,
               *, beam_size: int, max_len: int, alpha: float, int8_kv: bool,
               early_stop: bool, ctc_weight: float, prompt: Optional[Prompt],
               entry: Optional[_Step] = None) -> _Step:
        """Write the search's initial state and caches (what the eager
        search starts from: a prompt's rows included) and, with
        ``early_stop``, the test before the
        first step into the arena: into ``entry``'s views when given (a
        prologue being captured), else into the views of ``memory``'s step
        shape, taken here (growing the arena if need be), whose step is
        built if it has none. Returns that step."""
        b, k = memory.shape[0], beam_size
        off = 0 if prompt is None else prompt.offset
        spec: Spec = {}

        def store(name: str, t: torch.Tensor) -> torch.Tensor:
            if entry is not None:
                return entry.views[name].copy_(t)
            spec[name] = (tuple(t.shape), t.stride(), t.dtype)
            return self._take(name, *spec[name]).copy_(t)

        with named_scope("st.decode.init_cache"):
            cache = model.init_cache(memory, max_len + off, k, int8_kv,
                                     store=lambda name, t: store("cache." + name, t))
            _, own = split_cache(cache)
            sos_state = None
            if ctc_weight > 0.0:
                logp, lens, sos_state = ctc_prepare(model, memory, mem_lens)
                store("ctc.logp", logp)
                store("ctc.lens", lens)
                del logp
            carry = initial_carry(b, k, max_len, self.device, own, True, sos_state, prompt)
            for name, t in carry.items():
                if name != "cache":
                    store("carry." + name, t)
            read_prompt(model, prompt, cache, mem_lens, carry["lineage"])
            del cache, carry
            # int32, as the cross-attention kernel reads it: no cast in the step
            store("mem_lens", mem_lens.to(torch.int32))
            index = torch.zeros((), dtype=torch.int32, device=self.device)
            store("index", index.fill_(off) if off else index)
            if entry is None:
                key = (b, k, max_len, memory.shape[1], memory.dtype, int8_kv, float(alpha),
                       float(ctc_weight), prompt)
                spec["go"] = ((), (), torch.bool)
                self._specs[key] = spec
                entry = self._entry(model, key)
            if early_stop:   # the test before the first step
                entry.go.copy_(keep_going(entry.carry, entry.max_lp))
        return entry

    def search(self, model: SpeechTransformer, memory: torch.Tensor,
               mem_lens: torch.Tensor, *, beam_size: int, max_len: int, alpha: float,
               int8_kv: bool, early_stop: bool, ctc_weight: float = 0.0,
               prompt: Optional[Prompt] = None) -> BeamResult:
        """The beam search over encoded ``memory`` on the arena."""
        self._check_params(model)
        entry = self._start(model, memory, mem_lens, beam_size=beam_size, max_len=max_len,
                            alpha=alpha, int8_kv=int8_kv, early_stop=early_stop,
                            ctc_weight=ctc_weight, prompt=prompt)
        return self._search(model, entry, early_stop)

    def _inputs(self, call: _Call) -> Tuple[torch.Tensor, torch.Tensor]:
        """The arena's views of a call's PCM and sample lengths."""
        b, s = call.audio
        return (self._take("pcm", (b, s), (s, 1), call.audio_dtype),
                self._take("pcm.lens", (b,), (1,), call.lens_dtype))

    def _prologue(self, model: SpeechTransformer, call: _Call, pcm: torch.Tensor,
                  lens: torch.Tensor, entry: Optional[_Step] = None) -> _Step:
        """Features and encoder over the PCM views, then ``_start`` with the
        early stop's first test: the function a prologue graph captures."""
        feats, frame_lens = extract_features(pcm, lens, call.features, device=self.device)
        memory, mem_lens = encode_on(model, feats, frame_lens, self.device)
        del feats, frame_lens
        return self._start(model, memory, mem_lens, beam_size=call.beam_size,
                           max_len=call.max_len, alpha=call.alpha, int8_kv=call.int8_kv,
                           early_stop=True, ctc_weight=call.ctc_weight, prompt=call.prompt,
                           entry=entry)

    def prologue(self, model: SpeechTransformer, audio, sample_lens,
                 features: FeatureConfig, *, beam_size: int, max_len: int, alpha: float,
                 int8_kv: bool, ctc_weight: float = 0.0,
                 prompt: Optional[Prompt] = None) -> _Step:
        """A call's prologue from its padded PCM [B, S] and sample lengths
        [B] (host or device tensors or arrays): both copied into the arena,
        then its graph replayed, or, at a call shape's first call on the
        arena, the prologue run eagerly. Returns the step whose views hold
        the search's initial state."""
        self._check_params(model)
        audio, sample_lens = torch.as_tensor(audio), torch.as_tensor(sample_lens)
        call = _Call(tuple(audio.shape), audio.dtype, sample_lens.dtype, features,
                     beam_size, max_len, float(alpha), bool(int8_kv), float(ctc_weight), prompt)
        pcm, lens = self._inputs(call)   # a larger call grows them: no graph is left
        pcm.copy_(audio)
        lens.copy_(sample_lens)
        graph = self._prologues.get(call)
        if graph is None:
            entry = self._prologue(model, call, pcm, lens)
            self._calls[call] = entry.key
            interface.count_decode_steps("prologue_eager")
            return entry
        with named_scope("st.decode.prologue"):
            graph.replay()
        interface.count_decode_steps("prologue_replays")
        return self._steps[self._calls[call]]

    def decode(self, model: SpeechTransformer, audio, sample_lens, features: FeatureConfig,
               *, beam_size: int, max_len: int, alpha: float, int8_kv: bool,
               ctc_weight: float = 0.0, prompt: Optional[Prompt] = None) -> BeamResult:
        """``prologue``, then the beam search on the arena, with the early
        stop."""
        entry = self.prologue(model, audio, sample_lens, features, beam_size=beam_size,
                              max_len=max_len, alpha=alpha, int8_kv=int8_kv,
                              ctc_weight=ctc_weight, prompt=prompt)
        return self._search(model, entry, True)

    def _search(self, model: SpeechTransformer, entry: _Step, early_stop: bool) -> BeamResult:
        """The steps from the initial state in ``entry``'s views, then the
        result; on a card, every shape seen without a graph is captured."""
        _, _, max_len, _, _, _, alpha, _, _ = entry.key
        # A shape's first call on this arena runs its step eagerly.
        run, kind = ((entry.advance, "eager_steps") if entry.graph is None
                     else (entry.graph.replay, "replays"))

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
        """Capture every step shape and call shape seen that has no graph
        on the arena: the steps first, whose views the prologues fill."""
        for key in self._specs:
            entry = self._entry(model, key)
            if entry.graph is None:
                entry.graph = self._capture(entry.advance)
                interface.count_decode_steps("captures")
        for call, key in self._calls.items():
            if call not in self._prologues:
                entry, (pcm, lens) = self._steps[key], self._inputs(call)
                self._prologues[call] = self._capture(
                    functools.partial(self._prologue, model, call, pcm, lens, entry))
                interface.count_decode_steps("prologue_captures")


_GRAPHS: "weakref.WeakKeyDictionary[SpeechTransformer, StepGraphs]" = \
    weakref.WeakKeyDictionary()


def _arena(model: SpeechTransformer, device: torch.device) -> StepGraphs:
    """The model's arena on ``device``, made at its first call there and
    dropped with the model."""
    graphs = _GRAPHS.get(model)
    if graphs is None or graphs.device != device:
        graphs = _GRAPHS[model] = StepGraphs(device)
    return graphs


@torch.no_grad()
def graph_beam_search(model: SpeechTransformer, memory: torch.Tensor,
                      mem_lens: torch.Tensor, *, beam_size: int, max_len: int,
                      alpha: float = 1.0, int8_kv: bool = False,
                      early_stop: bool = True, ctc_weight: float = 0.0,
                      prompt: Optional[Prompt] = None) -> BeamResult:
    """``beam.eager_beam_search`` with the lineage table, on the model's
    static arena (``StepGraphs``): on a card each step is a CUDA graph
    replay after a shape's first call; on the CPU every step runs eagerly."""
    return _arena(model, memory.device).search(
        model, memory, mem_lens, beam_size=beam_size, max_len=max_len, alpha=alpha,
        int8_kv=int8_kv, early_stop=early_stop, ctc_weight=ctc_weight, prompt=prompt)


@torch.no_grad()
def graph_beam_decode(model: SpeechTransformer, audio, sample_lens,
                      features: FeatureConfig, *, beam_size: int, max_len: int,
                      alpha: float = 1.0, int8_kv: bool = False,
                      ctc_weight: float = 0.0, prompt: Optional[Prompt] = None) -> BeamResult:
    """``data.features.extract_features`` then ``beam.beam_decode`` with
    the lineage table and the early stop, from padded PCM [B, S] and sample
    lengths [B], on the
    model's arena on its own device: on a card the prologue and each step
    are CUDA graph replays after a call shape's first call; on the CPU both
    run eagerly."""
    if ctc_weight > 0.0:
        check_ctc_search(model, int8_kv)
    check_prompt_search(prompt, ctc_weight, True, model)
    return _arena(model, next(model.parameters()).device).decode(
        model, audio, sample_lens, features, beam_size=beam_size, max_len=max_len,
        alpha=alpha, int8_kv=int8_kv, ctc_weight=ctc_weight, prompt=prompt)
