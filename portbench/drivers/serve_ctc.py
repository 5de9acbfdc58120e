"""Serving the hybrid CTC/attention model through
``recognize.Recognizer.decode_result``: one caller, calls back to back
(a closed loop), as ``drivers/serve.py`` serves the attention-only model.

The configuration states ``model.ctc_head`` and ``decode.ctc_weight``: the
port's beam search scores every pre-beam candidate with its CTC prefix
score. Before anything is built, every key of the configuration file must
be a field of the port's configuration: ``config_from_dict`` drops the
keys it does not know, and a port without the CTC fields would quietly
serve the attention-only model. Set-up builds the ``Recognizer`` on the
seed's weights (``hybrid_params``: ``weights.make_params`` with <eos>'s
row zeroed, and the CTC head's own draw, under whose combined score
<eos> never wins either: the probability of a prefix as the whole
transcript, which needs every later frame to read blank or the prefix's
last token, lies far below its prefix score), the mix's
batches and one call of every shape. The window serves the batches in
the seed's order, cycling, until ``--seconds`` have passed (the mix's
``trace_items`` calls under the profiler with ``--trace 1``). Afterwards
the reference judges the hypotheses of a sample of the calls, drawn from
the seed with the longest in it, by the hybrid score and the hybrid prune
(``reference/ctc.judge``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional

import torch

from .. import traffic
from ..harness import Context, Record, free_device, port_config, score_gaps, synchronize
from ..reference import ctc as ref_ctc
from ..reference.model import Precision
from ..trace import reduce, traced
from ..weights import make_params
from .serve import sample_calls, serve


def check_fields(cfg: dict) -> None:
    """Raise unless every key of the configuration dictionary is a field of
    the port's ``ExperimentConfig``."""
    from speech_tranformer_pytorch_tpu_torch.config import ExperimentConfig

    default = ExperimentConfig()
    unknown = []
    for section, values in cfg.items():
        if section == "name":
            continue
        sub = getattr(default, section, None)
        if not dataclasses.is_dataclass(sub):
            unknown.append(section)
            continue
        known = {f.name for f in dataclasses.fields(sub)}
        unknown += [f"{section}.{k}" for k in values if k not in known]
    if unknown:
        raise RuntimeError(f"the port's configuration has no field {unknown}: this port "
                           "cannot run the configuration as it is stated")


def hybrid_params(ctx: Context):
    """The seed's weights of every parameter the reference lists, the CTC
    head's included (its own draw, from a generator seeded from the seed)."""
    m = ctx.cfg["model"]
    params = make_params(m, ctx.seed, ctx.device, never_end=True)
    g = torch.Generator(device=ctx.device)
    g.manual_seed((int(ctx.seed) * 0x9E3779B1 + 0xC7C) % (2 ** 63))
    for name, shape, init in ref_ctc.param_spec(m):
        if init == "fan_in":
            params[name] = torch.randn(shape, generator=g, device=ctx.device) / math.sqrt(shape[1])
        else:
            params[name] = torch.zeros(shape, device=ctx.device)
    return params


def build(ctx: Context, overrides: Optional[dict] = None):
    """A ``Recognizer`` on the seed's hybrid weights."""
    from speech_tranformer_pytorch_tpu_torch.config import apply_overrides
    from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer

    cfg = port_config(ctx.cfg)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    params = hybrid_params(ctx)
    rec = Recognizer(cfg, params, device=ctx.device)
    del params
    return rec


def check(ctx: Context, pool, items: List[dict], calls: List[int],
          control: Optional[Precision] = None) -> dict:
    """``serve.check``'s numbers under the hybrid score: ``score_gap_mean``,
    the mean gap between each served score and the reference's hybrid
    score of the same tokens; ``prune_gap_mean``, the mean over the
    utterances of the widest margin by which a candidate the search
    dropped, among each kept parent's pre-beam, outscores a kept
    hypothesis (``reference/ctc.judge``). ``control``: the reference in
    that precision serves in the port's place, through its own hybrid
    beam search."""
    params = hybrid_params(ctx)
    d = ctx.mix["decode"]
    beam, alpha, weight = d["beam_size"], d["alpha"], ctx.cfg["decode"]["ctc_weight"]
    gaps, prune = [], []
    for i in calls:
        hb = pool[items[i]["batch"]]
        audio = torch.from_numpy(hb.audio).to(ctx.device)
        lens = torch.from_numpy(hb.sample_lens).to(ctx.device)
        tokens, lengths, scores = items[i]["out"]
        if control is not None:
            scores, tokens = ref_ctc.beam_search(params, ctx.cfg, audio, lens, beam, hb.max_len,
                                                 alpha, weight, control)
            lengths = torch.full(scores.shape, hb.max_len)
        ref, margins = ref_ctc.judge(params, ctx.cfg, audio, lens, tokens, lengths, alpha,
                                     weight)
        gaps += score_gaps(scores, ref)
        prune += margins
    del params
    free_device(ctx.device)
    ctx.mark(f"check: {len(gaps)} hypotheses of {len(calls)} calls, widest score gap "
             f"{max(gaps)!r}, widest prune margin {max(prune)!r}")
    return {"score_gap_mean": sum(gaps) / len(gaps),
            "prune_gap_mean": sum(max(g, 0.0) for g in prune) / len(prune)}


def run(ctx: Context, *, overrides: Optional[dict] = None,
        fault: Optional[Callable] = None, min_items: int = 0,
        control: Optional[Precision] = None) -> Record:
    """One run; the keywords are ``serve.run``'s (the control and the
    fault readings of ``calibrate_ctc.py`` and the tests)."""
    check_fields(ctx.cfg)
    decode = ctx.mix["decode"]
    rec = build(ctx, overrides)
    ctx.mark("recognizer built")
    pool = traffic.build_pool(ctx.mix, ctx.cfg, ctx.seed, train=False)
    ctx.mark("host batches made")
    seen = set()
    for hb in pool:                       # warm every shape this mix serves
        if hb.shape_key() not in seen:
            seen.add(hb.shape_key())
            serve(rec, hb, decode)
            ctx.mark(f"warmed {hb.audio.shape[0]} x {hb.audio.shape[1]} samples, "
                     f"{hb.max_len} steps")
    synchronize(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.mark("shapes warmed")

    frames = [traffic.frames_of(hb.sample_lens, ctx.cfg["features"]).tolist() for hb in pool]
    items: List[dict] = []
    with traced(ctx.trace, ctx.device) as box:
        t0 = time.perf_counter()
        while (len(items) < ctx.mix["trace_items"] if ctx.trace
               else time.perf_counter() - t0 < ctx.seconds or len(items) < min_items):
            j = len(items) % len(pool)
            hb = pool[j]
            t = time.perf_counter()
            out, steps = serve(rec, hb, decode)
            wall = time.perf_counter() - t
            if fault is not None:
                out = fault(out)
            items.append(dict(batch=j, wall_s=wall, audio_s=hb.seconds, steps=steps,
                              b=hb.audio.shape[0], beam=decode["beam_size"],
                              frames=frames[j], max_len=hb.max_len, out=out))
        synchronize(ctx.device)
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    ctx.mark(f"window: {len(items)} calls, {sum(it['steps'] for it in items)} decode steps "
             f"in {window_s:.3f} s")
    trace = reduce(box[0]) if box else None
    del rec
    free_device(ctx.device)
    failed = sum(1 for it in items if not bool(torch.isfinite(it["out"][2]).all()))
    numbers = check(ctx, pool, items, sample_calls(items, ctx.mix["check_calls"], ctx.seed),
                    control)
    for it in items:
        it["tokens"] = it.pop("out")[0].numpy()
    return Record(kind="serve", setup_s=setup_s, window_s=window_s, items=items,
                  peak_bytes=int(peak), attempted=len(items), failed=failed,
                  numbers=numbers, trace=trace)
