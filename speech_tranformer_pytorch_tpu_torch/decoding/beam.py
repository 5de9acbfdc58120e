"""Batched beam-search decoding (counterpart of the JAX package's
``decoding/beam.py``).

The whole batch and all K beams advance together; state is fixed-shape
[B, K, ...]. Each step takes the top-2K candidates over the flattened K·V
scores (``kernels/interface.beam_candidate_topk``), routes <eos> candidates
to the finished pool and keeps the best K others alive. By default
(``use_lineage=True``) the self-attention KV cache is never reordered: a
[B, K, L] lineage table records which cache lane holds each beam's step-j
entry. ``use_lineage=False`` gathers the cache by beam after every step
instead, as JAX's ``_gather_beams`` does, and attends in plain PyTorch.
Finished hypotheses are ranked by ``score / lp(len)`` with the GNMT
penalty ``lp(n) = ((5+n)/6)^alpha``. With ``early_stop`` (the default) the
loop stops as soon as no alive beam can beat the worst finished one (an
exact bound, not an approximation), which costs one host sync a step;
``early_stop=False`` runs exactly ``max_len`` steps with no host sync, the
fixed-trip loop that ``serving.export_recognizer`` exports, with the same
results. Every top-k uses ``topk_stable``, whose tie order is
``jax.lax.top_k``'s.

With ``ctc_weight`` λ > 0 (``decode.ctc_weight``, a model with a CTC
head) the search is ESPnet's hybrid CTC/attention beam search: each alive
hypothesis keeps its P = int(1.5 K) best tokens by attention log-prob (the
pre-beam, through the same prune kernel at one beam a row), each of them
scores alive + (1 − λ)·log p_att(c) + λ·(ψ(g·c) − ψ(g)) with ψ the CTC
prefix score (``kernels/interface.ctc_prefix_scores``), and the same
finished/alive bookkeeping runs over the K·P candidates of an utterance.
Each hypothesis carries its CTC state over the encoder frames and its ψ,
which follow the chosen parent every step (``ctc_carry``); the log-probs
and the <sos> state are computed once a call (``ctc_prepare``). Both parts
of a score only fall, so the early stop stays exact. Greedy search, export,
a mesh and int8 serving have no CTC scorer and refuse λ > 0.

With a ``Prompt`` (``decode.prompt``, ``decode.suppress`` and
``decode.suppress_first``: Whisper's forced start and ``SuppressTokens`` /
``SuppressBlank``) the decoder first reads the forced tokens: all but the
last are fed to every lane as ordinary decode steps at cache positions
0 .. n - 2 (``read_prompt``), each lane writing its own rows, whose
logits go unused; the last is every lane's first input, as <sos> is
without a prompt, and the search's steps run from cache position n - 1.
Each step adds a row of -1e9 at the suppressed ids to the logits before
the prune (the first step's row also at ``suppress_first``), so the
prune's log-softmax leaves them out of its sum as Whisper's filters do. Hypotheses, lengths and the
penalty count sampled tokens alone. A prompt has no CTC, greedy, export
or ``use_lineage=False`` path, and those refuse it.

On a card, with the lineage table, a model without a mesh and nothing
being exported, ``beam_search`` replays each step as a CUDA graph
(``decoding/beam_graph.py``); everywhere else it runs
``eager_beam_search``. Both run the one step function, ``beam_step``, and
give the same results.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..data.tokenizer import EOS, PAD, SOS
from ..device import DeviceLike, resolve_device
from ..kernels import interface
from ..kernels.ctc_prefix import LOGZERO
from ..models import SpeechTransformer
from ..ops.masks import NEG_INF
from ..ops.topk import topk_stable
from ..utils.profiling import named_scope


def length_penalty(lengths: torch.Tensor, alpha: float) -> torch.Tensor:
    """GNMT length normalisation factor lp(n) = ((5+n)/6)^alpha (float32)."""
    return torch.pow((5.0 + lengths.float()) / 6.0, alpha)


@dataclasses.dataclass(frozen=True)
class BeamResult:
    tokens: torch.Tensor     # [B, K, L] token ids (eos-terminated, pad tail)
    lengths: torch.Tensor    # [B, K] lengths excluding eos
    scores: torch.Tensor     # [B, K] length-penalized log-probs, sorted desc
    steps: int               # decode steps run before the stop


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[..., None...], axis=1)`` for [B, N, ...] x."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def _gather_beams(x: torch.Tensor, src_beam: torch.Tensor) -> torch.Tensor:
    """Reorder the [B·K, ...] rows of ``x`` by ``src_beam`` [B, K]."""
    b, k = src_beam.shape
    return _take(x.reshape((b, k) + x.shape[1:]), src_beam).reshape(x.shape)


_SELF = ("self_k", "self_v")


@dataclasses.dataclass(frozen=True)
class Prompt:
    """A forced start and the ids a search never emits (module docstring):
    ``tokens`` the decoder reads before the first sampled token,
    ``suppress`` banned at every step, ``suppress_first`` at the first."""
    tokens: Tuple[int, ...] = (SOS,)
    suppress: Tuple[int, ...] = ()
    suppress_first: Tuple[int, ...] = ()

    @classmethod
    def of(cls, decode) -> Optional["Prompt"]:
        """The prompt of a ``DecodeConfig``; None where it sets none."""
        if not (decode.prompt or decode.suppress or decode.suppress_first):
            return None
        return cls(tuple(decode.prompt) or (SOS,), tuple(decode.suppress),
                   tuple(decode.suppress_first))

    @property
    def offset(self) -> int:
        """The cache position of the search's first step: the tokens
        ``read_prompt`` feeds."""
        return len(self.tokens) - 1

    def ban_rows(self, vocab: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(every step's, the first step's) additive rows [V] f32: -1e9 at
        the suppressed ids, 0 elsewhere."""
        rows = torch.zeros((2, vocab), device=device)
        rows[:, list(self.suppress)] = NEG_INF
        rows[1, list(self.suppress_first)] = NEG_INF
        return rows[0], rows[1]


def read_prompt(model: SpeechTransformer, prompt: Optional[Prompt], cache, mem_lens,
                lineage: torch.Tensor) -> None:
    """Feed a prompt's tokens but the last through ``model.decode_step`` at
    cache positions 0 .. n - 2, each to every lane, which writes its own
    self K/V rows through ``lineage`` (``initial_carry``'s identity table);
    their logits go unused. Nothing without a prompt or with a one-token
    one. Ids and positions are made on the device, so a CUDA graph
    captures it."""
    if prompt is None or not prompt.offset:
        return
    b, k = lineage.shape[:2]
    dev = lineage.device
    with named_scope("st.decode.prompt"):
        index = torch.arange(prompt.offset, dtype=torch.int32, device=dev)
        for j, t in enumerate(prompt.tokens[:-1]):
            model.decode_step(torch.full((b * k,), t, dtype=torch.int32, device=dev),
                              index[j], cache, mem_lens, k, lineage)


def split_cache(cache):
    """(the decode cache's beam-invariant part, its self-attention K/V): the
    first is read by every step, the second is the decode loop's carry."""
    const = {n: {key: t for key, t in c.items() if key not in _SELF}
             for n, c in cache.items()}
    own = {n: {key: c[key] for key in _SELF} for n, c in cache.items()}
    return const, own


def decode_step(model: SpeechTransformer, tokens, index, const, own, mem_lens,
                beam_width: int, lineage):
    """``model.decode_step`` on a cache held as ``split_cache`` parts:
    (logits, the new self-attention K/V)."""
    with named_scope("st.decode.forward"):
        cache = {n: {**c, **own.get(n, {})} for n, c in const.items()}
        logits, cache = model.decode_step(tokens, index, cache, mem_lens, beam_width,
                                          lineage)
        return logits, {n: {key: cache[n][key] for key in _SELF} for n in own}


def decode_loop(step, carry, indices, *, stop=None, kind: str = "eager_steps"):
    """Run ``carry = step(carry, indices[n])`` for n = 0 .. len(indices) - 1;
    returns (carry, steps run). ``indices[n]`` is step n's index, a 0-d
    int32 tensor on the step's device: a view of one ``torch.arange`` made
    once a call (no launch a step), or a graph arena's own index, which its
    step advances (``decoding/beam_graph.py``).

    Eagerly this is a Python loop; ``stop(carry)``, when given, is asked
    before each step and ends the loop early (one host sync a step). While
    ``torch.export`` traces, it is one ``while_loop`` whose step is traced
    once with its index carried as a 0-d int32 on the indices' device, and
    whose test reads a step counter kept on the host, so the exported loop
    runs all its steps with no device sync; ``stop`` must be None.

    Under a profiler each eager step is an ``st.decode.step`` span, which
    holds the step and the stop test after it (``st.decode.stop``); the
    test before the first step is in no step span. The steps run count as
    ``kind`` (``kernels/interface.decode_step_counts``): "eager_steps", or
    "replays" where each step replays a CUDA graph."""
    max_len = len(indices)
    if torch.compiler.is_exporting():
        if stop is not None:
            raise ValueError("an exported decode loop runs a fixed number of steps: "
                             "pass early_stop=False")
        from torch._higher_order_ops.while_loop import while_loop
        from torch.utils import _pytree as pytree

        leaves, spec = pytree.tree_flatten(carry)

        def body(n, i, *leaves):
            out = step(pytree.tree_unflatten(list(leaves), spec), i)
            return (n + 1, i + 1, *pytree.tree_leaves(out))

        _, _, *leaves = while_loop(
            lambda n, i, *_: n < max_len, body,
            (torch.zeros((), dtype=torch.int64),                      # host counter
             torch.zeros((), dtype=torch.int32, device=indices.device), *leaves))
        return pytree.tree_unflatten(leaves, spec), max_len

    def stopped(c) -> bool:
        if stop is None:
            return False
        with named_scope("st.decode.stop"):
            return stop(c)

    steps = 0
    done = max_len <= 0 or stopped(carry)
    while not done:
        with named_scope("st.decode.step"):
            carry = step(carry, indices[steps])
            steps += 1
            done = steps == max_len or stopped(carry)
    interface.count_decode_steps(kind, steps)
    return carry, steps


class CTCPrefix(NamedTuple):
    """The CTC side of a hybrid search, fixed for a call."""
    logp: torch.Tensor      # [B, V, T'] f32 log-probs, frames last
    lens: torch.Tensor      # [B] int32 valid frames
    weight: float           # λ, the CTC share of a candidate's score


def pre_beam_size(k: int) -> int:
    """Tokens a hypothesis keeps by attention log-prob before CTC scoring
    (ESPnet's ``pre_beam_ratio`` 1.5)."""
    return int(1.5 * k)


def ctc_prepare(model: SpeechTransformer, memory: torch.Tensor, mem_lens: torch.Tensor):
    """(log-probs [B, V, T'] frames last, valid lengths int32 [B], the
    <sos> state [B, 2, T']: rⁿ = log 0, rᵇ_t = Σ_{τ<=t} x_τ(blank)), once
    a call."""
    with named_scope("st.ctc.init"):
        logp = model.ctc_log_probs(memory, mem_lens)            # [B, T', V]
        blank = logp[:, :, PAD]
        state = torch.stack([torch.full_like(blank, LOGZERO), torch.cumsum(blank, 1)], 1)
        return logp.transpose(1, 2).contiguous(), mem_lens.to(torch.int32), state


def ctc_carry(psi: torch.Tensor, states: torch.Tensor, sel: torch.Tensor):
    """The chosen candidates' ψ [B, K] and states [B·K, 2, T'], gathered
    from every candidate's (``psi`` [B, N], ``states`` [B, N, 2, T']) by
    ``sel`` [B, K]: each state follows its parent."""
    return _take(psi, sel), _take(states, sel).flatten(0, 1)


def initial_carry(b: int, k: int, max_len: int, device, own, use_lineage: bool,
                  ctc_state: Optional[torch.Tensor] = None,
                  prompt: Optional[Prompt] = None) -> dict:
    """The search's state before step 0, holding the self-attention K/V
    ``own``: <sos> (a prompt's last token) for every beam, with only beam
    0 live (all beams would be identical), empty pools, and the identity
    lineage table (over a prompt's positions too); with ``ctc_state``
    ([B, 2, T'], ``ctc_prepare``'s) every beam's CTC state and ψ = 0."""
    i32 = dict(dtype=torch.int32, device=device)
    first, off = (SOS, 0) if prompt is None else (prompt.tokens[-1], prompt.offset)
    alive_scores = torch.full((b, k), NEG_INF, device=device)
    alive_scores[:, 0].fill_(0.0)   # made on the device: a CUDA graph can capture it
    carry = dict(
        cur_tokens=torch.full((b, k), first, **i32),
        alive_tokens=torch.full((b, k, max_len), PAD, **i32),
        alive_scores=alive_scores,
        fin_tokens=torch.full((b, k, max_len), PAD, **i32),
        fin_scores=torch.full((b, k), NEG_INF, device=device),
        fin_lens=torch.zeros((b, k), **i32), cache=own)
    if use_lineage:
        # lineage[b, k, j]: the cache lane holding beam k's step-j key/value.
        carry["lineage"] = torch.arange(k, **i32)[None, :, None].expand(
            b, k, max_len + off).clone()
    if ctc_state is not None:
        carry["ctc_state"] = ctc_state.repeat_interleave(k, 0)
        carry["ctc_psi"] = torch.zeros((b, k), device=device)
    return carry


def beam_step(model: SpeechTransformer, const, mem_lens: torch.Tensor, *, b: int, k: int,
              max_len: int, alpha: float, use_lineage: bool, device,
              ctc: Optional[CTCPrefix] = None, prompt: Optional[Prompt] = None):
    """Beam search's step: ``step(carry, i)`` runs step ``i`` (a 0-d int32
    tensor on ``device``: the cache position, ``prompt.offset`` at the
    first step) from ``carry`` (``initial_carry``'s keys) and
    returns the next carry: the decoder step over the cache held
    as ``split_cache`` parts (``const``, and the carry's own self K/V, which
    the step writes in place), then the prune and the beam bookkeeping;
    with ``ctc``, the pre-beam, CTC prefix scoring and the bookkeeping over
    the K·P candidates; with ``prompt``, the suppression before the prune
    (module docstring)."""
    i32 = dict(dtype=torch.int32, device=device)
    off = 0 if prompt is None else prompt.offset
    identity = torch.arange(k, **i32)[None, :, None].expand(b, k, max_len + off)
    positions = torch.arange(max_len, device=device)[None, None, :]   # a token's step
    cache_positions = positions
    if off:
        positions = positions + off
        cache_positions = torch.arange(max_len + off, device=device)[None, None, :]
    bans = None if prompt is None else prompt.ban_rows(model.cfg.vocab_size, device)
    if ctc is not None:
        n_pre = pre_beam_size(k)
        no_alive = torch.zeros((b * k, 1), device=device)   # the pre-beam's row scores

    def candidates(c, i, logits):
        """(scores [B, 2K], parent beams, tokens, and with ``ctc`` every
        candidate's ψ [B, K·P], states and flat index [B, 2K])."""
        v = logits.shape[-1]
        if bans is not None:
            logits = logits + torch.where(i == off, bans[1], bans[0])
        if ctc is None:
            top_scores, top_idx = interface.beam_candidate_topk(
                logits, c["alive_scores"], k2=2 * k, pad_id=PAD, sos_id=SOS)
            top_idx = top_idx.long()
            return (top_scores, torch.div(top_idx, v, rounding_mode="floor"),
                    (top_idx % v).to(torch.int32), None)
        att, tok = interface.beam_candidate_topk(logits, no_alive, k2=n_pre,
                                                 pad_id=PAD, sos_id=SOS)   # [B·K, P]
        with named_scope("st.decode.ctc"):
            psi, states = interface.ctc_prefix_scores(
                ctc.logp, c["ctc_state"], c["cur_tokens"].reshape(b * k), tok, i, ctc.lens,
                beams=k, blank=PAD, eos=EOS)
        cand = (c["alive_scores"].reshape(b * k, 1) + (1.0 - ctc.weight) * att
                + ctc.weight * (psi - c["ctc_psi"].reshape(b * k, 1)))
        top_scores, flat = topk_stable(cand.reshape(b, k * n_pre), 2 * k)
        states = states.reshape((b, k * n_pre) + states.shape[2:])
        return (top_scores, torch.div(flat, n_pre, rounding_mode="floor"),
                torch.gather(tok.reshape(b, k * n_pre), 1, flat),
                (psi.reshape(b, k * n_pre), states, flat))

    def search(c, i, logits, own):
        # The prune and the beam bookkeeping of step i.
        top_scores, top_beam, top_tok, scored = candidates(c, i, logits)

        seqs = torch.where(positions == i, top_tok[:, :, None],        # [B, 2K, L]
                           _take(c["alive_tokens"], top_beam))
        is_eos = top_tok == EOS

        # Finished pool: the existing K plus the new <eos> candidates.
        new_fin_lens = torch.zeros((b, 2 * k), **i32) + (i - off if off else i)
        penalized = top_scores / length_penalty(new_fin_lens, alpha)
        cand_fin = torch.where(is_eos, penalized, torch.full_like(penalized, NEG_INF))
        fin_scores, fin_sel = topk_stable(torch.cat([c["fin_scores"], cand_fin], 1), k)
        out = dict(
            fin_scores=fin_scores.contiguous(),   # a carry keeps its strides
            fin_tokens=_take(torch.cat([c["fin_tokens"], seqs], 1), fin_sel),
            fin_lens=_take(torch.cat([c["fin_lens"], new_fin_lens], 1), fin_sel))

        # Alive set: the best K non-eos candidates.
        alive_cand = torch.where(is_eos, torch.full_like(top_scores, NEG_INF),
                                 top_scores)
        alive_scores, alive_sel = topk_stable(alive_cand, k)
        out["alive_scores"] = alive_scores.contiguous()
        out["alive_tokens"] = _take(seqs, alive_sel)
        out["cur_tokens"] = _take(top_tok, alive_sel)
        src_beam = _take(top_beam, alive_sel)                  # [B, K]
        if scored is not None:
            psi, states, flat = scored
            with named_scope("st.decode.ctc"):
                out["ctc_psi"], out["ctc_state"] = ctc_carry(psi, states,
                                                             _take(flat, alive_sel))

        if use_lineage:
            # Compose the beam permutation into the lineage table: columns
            # <= i follow the chosen parents, later columns stay identity.
            out["lineage"] = torch.where(cache_positions <= i,
                                         _take(c["lineage"], src_beam), identity)
        else:   # gather the self cache (cross K/V are beam-invariant)
            own = {n: {key: _gather_beams(t, src_beam) for key, t in layer.items()}
                   for n, layer in own.items()}
        out["cache"] = own
        return {key: out[key] for key in c}   # in the carry's order

    def step(c, i):
        logits, own = decode_step(model, c["cur_tokens"].reshape(b * k), i, const,
                                  c["cache"], mem_lens, k, c.get("lineage"))
        with named_scope("st.decode.search"):
            return search(c, i, logits, own)

    return step


def stop_bound(max_len: int, alpha: float, device) -> torch.Tensor:
    """lp(max_len) on ``device``: what ``keep_going`` divides by."""
    return length_penalty(torch.tensor(max_len), alpha).to(device)


def keep_going(c, max_lp: torch.Tensor) -> torch.Tensor:
    """The early-stop test of a carry, a 0-d bool on its device: false once
    no alive hypothesis can beat the worst finished one anywhere. An alive
    hypothesis can at best reach score / lp(max_len), so then the steps
    left would change nothing: the stop is exact."""
    bound = c["alive_scores"].max(dim=1).values / max_lp
    worst_fin = c["fin_scores"].min(dim=1).values
    pool_full = worst_fin > NEG_INF / 2.0
    return torch.any(~pool_full | (bound > worst_fin))


def finalize(c, steps: int, alpha: float) -> BeamResult:
    """The result of a finished carry: still-alive beams join the pool,
    penalized at full length, and the best K of it are kept."""
    b, k = c["alive_scores"].shape
    max_len = c["alive_tokens"].shape[-1]
    i32 = dict(dtype=torch.int32, device=c["alive_scores"].device)
    alive_pen = c["alive_scores"] / length_penalty(
        torch.full((b, k), max_len, **i32), alpha)
    all_scores = torch.cat([c["fin_scores"], alive_pen], 1)
    all_tokens = torch.cat([c["fin_tokens"], c["alive_tokens"]], 1)
    all_lens = torch.cat([c["fin_lens"], torch.full((b, k), max_len, **i32)], 1)
    final_scores, sel = topk_stable(all_scores, k)
    return BeamResult(tokens=_take(all_tokens, sel), lengths=_take(all_lens, sel),
                      scores=final_scores, steps=steps)


def check_prompt_search(prompt: Optional[Prompt], ctc_weight: float, use_lineage: bool,
                        model: SpeechTransformer) -> None:
    """Raise where a search with a prompt has no path: CTC prefix scores,
    the beam-gathered cache (``use_lineage=False``), export, a mesh."""
    if prompt is None:
        return
    why = [what for what, on in (
        ("decode.ctc_weight > 0", ctc_weight > 0.0), ("use_lineage=False", not use_lineage),
        ("export", torch.compiler.is_exporting()), ("a mesh", model.decoder.mesh is not None))
        if on]
    if why:
        raise ValueError(f"a forced prompt or suppressed ids (decode.prompt, decode.suppress, "
                         f"decode.suppress_first) are served by the single-device beam search "
                         f"with the lineage table alone: {why} has no path for them")


def check_ctc_search(model: SpeechTransformer, int8: bool) -> None:
    """Raise where a hybrid CTC/attention search (``ctc_weight`` > 0) has
    no path: a model without a CTC head, a mesh, export, int8 serving."""
    if model.ctc is None:
        raise ValueError("decode.ctc_weight > 0 needs a model with a CTC head "
                         "(model.ctc_head=True)")
    if model.decoder.mesh is not None:
        raise ValueError("decode.ctc_weight > 0 is single-device: CTC prefix scoring "
                         "has no tensor-parallel path")
    if torch.compiler.is_exporting():
        raise ValueError("decode.ctc_weight > 0 cannot be exported: the exported "
                         "decode loop has no CTC prefix scorer")
    if int8:
        raise ValueError("decode.ctc_weight > 0 has no int8 serving path: turn "
                         "decode.int8_weights and decode.int8_kv_cache off")


def replays_graphs(model: SpeechTransformer, device: torch.device, max_len: int,
                   use_lineage: bool) -> bool:
    """Whether a beam search on ``device`` replays CUDA graphs
    (``beam_search`` its steps, ``recognize.Recognizer`` each call's
    prologue too): on a card, with the lineage table and at least one
    step, for a model without a mesh (tensor-parallel collectives stay
    eager), and not while ``torch.export`` traces (the exported loop is a
    ``while_loop``)."""
    return (use_lineage and device.type == "cuda" and max_len > 0
            and model.decoder.mesh is None and not torch.compiler.is_exporting())


@torch.no_grad()
def beam_search(
    model: SpeechTransformer,
    memory: torch.Tensor,        # [B, S, d_model]
    mem_lens: torch.Tensor,      # [B]
    *,
    beam_size: int,
    max_len: int,
    alpha: float = 1.0,
    int8_kv: bool = False,
    early_stop: bool = True,
    use_lineage: bool = True,
    ctc_weight: float = 0.0,
    prompt: Optional[Prompt] = None,
) -> BeamResult:
    """Beam search over encoded ``memory``: replayed as CUDA graphs where
    ``replays_graphs`` (``beam_graph.graph_beam_search``), else
    ``eager_beam_search``; hybrid CTC/attention with ``ctc_weight`` > 0;
    from a forced ``prompt``."""
    if ctc_weight > 0.0:
        check_ctc_search(model, int8_kv)
    check_prompt_search(prompt, ctc_weight, use_lineage, model)
    kw = dict(beam_size=beam_size, max_len=max_len, alpha=alpha, int8_kv=int8_kv,
              early_stop=early_stop, ctc_weight=ctc_weight, prompt=prompt)
    if replays_graphs(model, memory.device, max_len, use_lineage):
        from .beam_graph import graph_beam_search

        return graph_beam_search(model, memory, mem_lens, **kw)
    return eager_beam_search(model, memory, mem_lens, use_lineage=use_lineage, **kw)


@torch.no_grad()
def eager_beam_search(
    model: SpeechTransformer,
    memory: torch.Tensor,        # [B, S, d_model]
    mem_lens: torch.Tensor,      # [B]
    *,
    beam_size: int,
    max_len: int,
    alpha: float = 1.0,
    int8_kv: bool = False,
    early_stop: bool = True,
    use_lineage: bool = True,
    ctc_weight: float = 0.0,
    prompt: Optional[Prompt] = None,
) -> BeamResult:
    """Beam search issuing every step's kernels from Python
    (``decode_loop``)."""
    check_prompt_search(prompt, ctc_weight, use_lineage, model)
    b, k = memory.shape[0], beam_size
    dev = memory.device
    off = 0 if prompt is None else prompt.offset
    with named_scope("st.decode.init_cache"):
        cache = model.init_cache(memory, max_len + off, k, int8_kv)
        const, own = split_cache(cache)
    ctc, sos_state = None, None
    if ctc_weight > 0.0:
        logp, lens, sos_state = ctc_prepare(model, memory, mem_lens)
        ctc = CTCPrefix(logp, lens, float(ctc_weight))
    carry = initial_carry(b, k, max_len, dev, own, use_lineage, sos_state, prompt)
    if prompt is not None:
        read_prompt(model, prompt, cache, mem_lens, carry["lineage"])
    del cache
    step = beam_step(model, const, mem_lens, b=b, k=k, max_len=max_len, alpha=alpha,
                     use_lineage=use_lineage, device=dev, ctc=ctc, prompt=prompt)
    done = None
    if early_stop:
        max_lp = stop_bound(max_len, alpha, dev)

        def done(c) -> bool:
            return not bool(keep_going(c, max_lp))

    c, steps = decode_loop(step, carry, torch.arange(off, max_len + off, dtype=torch.int32,
                                                     device=dev), stop=done)
    with named_scope("st.decode.finalize"):
        return finalize(c, steps, alpha)


@torch.no_grad()
def beam_decode(
    model: SpeechTransformer,
    feats,
    frame_lens,
    *,
    beam_size: int,
    max_len: int,
    alpha: float = 1.0,
    int8_kv: bool = False,
    device: DeviceLike = None,
    early_stop: bool = True,
    use_lineage: bool = True,
    ctc_weight: float = 0.0,
    prompt: Optional[Prompt] = None,
) -> BeamResult:
    """Encode + beam search on ``device`` (CUDA unless the caller asks for
    the CPU); the model must already live there."""
    memory, mem_lens = encode_on(model, feats, frame_lens, device)
    return beam_search(model, memory, mem_lens, beam_size=beam_size,
                       max_len=max_len, alpha=alpha, int8_kv=int8_kv,
                       early_stop=early_stop, use_lineage=use_lineage,
                       ctc_weight=ctc_weight, prompt=prompt)


def encode_on(model: SpeechTransformer, feats, frame_lens, device: DeviceLike):
    """Run the encoder on ``device``, where the model must already live."""
    dev = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"model is on {param.device}, decoding on {dev}")
    with named_scope("st.encode"):
        feats = torch.as_tensor(feats).to(dev)
        frame_lens = torch.as_tensor(frame_lens).to(dev)
        return model.encode(feats, frame_lens)


def best_hypotheses(result: BeamResult) -> List[List[int]]:
    """Top beam of each utterance -> python lists."""
    t = result.tokens[:, 0].cpu().numpy()
    l = result.lengths[:, 0].cpu().numpy()
    return [t[i, :l[i]].tolist() for i in range(t.shape[0])]
