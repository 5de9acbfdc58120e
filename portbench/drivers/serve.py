"""Serving through ``recognize.Recognizer.decode_result``: one caller,
calls back to back (a closed loop).

Set-up builds the ``Recognizer`` on the seed's weights (whose ``<eos>``
never wins: ``weights.make_params``), the mix's batches
in host memory, and decodes one batch of every (audio shape, decode
length) the mix holds. The window then serves the batches in the seed's
order, cycling, until ``--seconds`` have passed: a call's wall runs from
the int16 PCM on the host to the hypotheses, their lengths and scores on
the host. With ``--trace 1`` the window is the mix's ``trace_items`` calls
under the profiler. Afterwards the reference scores every hypothesis of a
sample of the finished calls, drawn from the seed with the longest call in
it, and judges the prune that kept them.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import traffic
from ..harness import Context, Record, free_device, port_config, score_gaps, synchronize
from ..reference.model import Precision
from ..reference.serve import beam_search, judge
from ..trace import reduce, traced
from ..weights import make_params


def build(ctx: Context, overrides: Optional[dict] = None):
    """A ``Recognizer`` on the seed's weights."""
    from speech_tranformer_pytorch_tpu_torch.config import apply_overrides
    from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer

    cfg = port_config(ctx.cfg)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    params = make_params(ctx.cfg["model"], ctx.seed, ctx.device, never_end=True)
    rec = Recognizer(cfg, params, device=ctx.device)
    del params
    return rec


def serve(rec, hb: traffic.HostBatch, decode: dict):
    """One call: hypotheses, lengths and scores on the host, and steps run."""
    res = rec.decode_result(torch.from_numpy(hb.audio), torch.from_numpy(hb.sample_lens),
                            beam_size=decode["beam_size"], max_len=hb.max_len,
                            alpha=decode["alpha"])
    return (res.tokens.cpu(), res.lengths.cpu(), res.scores.cpu()), rec.last_steps


def sample_calls(items: List[dict], n: int, seed: int) -> List[int]:
    """The longest finished call and ``n - 1`` others drawn from ``seed``."""
    longest = max(range(len(items)), key=lambda i: (items[i]["steps"] * items[i]["b"],
                                                     items[i]["audio_s"]))
    rest = [i for i in range(len(items)) if i != longest]
    rng = np.random.default_rng([int(seed), 0xc4ec])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + sorted(rest[int(j)] for j in pick)


def check(ctx: Context, pool, items: List[dict], calls: List[int],
          control: Optional[Precision] = None) -> dict:
    """The numbers compared, over every utterance of the sampled calls
    (``reference.serve.judge``). ``score_gap_mean``: the mean gap, over
    every hypothesis (all beams), between its served score and the
    reference's score of the same tokens. ``prune_gap_mean``: the mean,
    over the utterances, of the widest margin by which an extension that
    the search dropped outscores a hypothesis it kept
    (``reference.serve.prune_gaps``), nought where none does: a search that
    keeps the wrong candidates serves hypotheses whose scores add up, but
    not the best ones. The widest of each is noted on standard error.
    ``control``: the reference in that precision serves in the port's
    place, through its own beam search, with its own scores."""
    params = make_params(ctx.cfg["model"], ctx.seed, ctx.device, never_end=True)
    beam, alpha = ctx.mix["decode"]["beam_size"], ctx.mix["decode"]["alpha"]
    gaps, prune = [], []
    for i in calls:
        hb = pool[items[i]["batch"]]
        audio = torch.from_numpy(hb.audio).to(ctx.device)
        lens = torch.from_numpy(hb.sample_lens).to(ctx.device)
        tokens, lengths, scores = items[i]["out"]
        if control is not None:
            scores, tokens = beam_search(params, ctx.cfg, audio, lens, beam, hb.max_len,
                                         alpha, control)
            lengths = torch.full(scores.shape, hb.max_len)
        ref, margins = judge(params, ctx.cfg, audio, lens, tokens, lengths, alpha)
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
    """One run. ``overrides`` (port config keys), ``fault`` (applied to
    each call's host outputs), ``min_items`` (calls the window makes at
    least) and ``control`` (see ``check``) serve the control and the fault
    tests."""
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
                              frames=frames[j],
                              max_len=hb.max_len, out=out))
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
