"""Serving OpenAI's Whisper (the port's ``whisper_large_v3`` preset: its
log-mel front end, Conv1d stem, forced prompt and suppressed ids) through
``recognize.Recognizer.decode_result``: one caller, calls back to back (a
closed loop), as ``drivers/serve.py`` serves the Speech-Transformer.

Before anything is built, every key of the configuration file must be a
field of the port's configuration (``serve_ctc.check_fields``): a port
without Whisper's fields would quietly serve another model, so such a port
exits here, within seconds and with no result. Set-up builds the
``Recognizer`` on the seed's weights (``whisper_params``: every leaf of
``reference/whisper.param_spec`` drawn on the device in one call, the
<eos> (<|endoftext|>) row of the tied embedding zeroed as
``weights.make_params`` does), the mix's batches and one call of every
shape. The window serves the batches in the seed's order, cycling, until
``--seconds`` have passed (the mix's ``trace_items`` calls under the
profiler with ``--trace 1``). Afterwards the reference judges the
hypotheses of a sample of the calls, drawn from the seed with the longest
in it (``reference/whisper.judge``).

Each item records what the readers read: the steps run, the beam, the
batch and, for ``work/whisper.py``, ``enc_frames``, the encoder frames of
every utterance (the whole window's: Whisper pads every input to it). The
existing readers count encoder frames from ``frames`` by the conv2d
subsampler's rule (``work/model.subsampled``), so ``frames`` holds, for
each utterance, the fbank count whose rule gives those same encoder frames.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional

import torch

from .. import traffic
from ..harness import Context, Record, free_device, port_config, score_gaps, synchronize
from ..reference import whisper as ref
from ..reference.model import Precision
from ..trace import reduce, traced
from ..weights import EOS
from .serve import sample_calls, serve
from .serve_ctc import check_fields


def whisper_params(ctx: Context):
    """The seed's weights of every leaf ``reference/whisper.param_spec``
    lists, made on the device from one draw (LeCun std 1/√fan-in, the
    embedding and the learned positions 1/√d), biases zero, LayerNorm
    scales one."""
    spec = ref.param_spec(ctx.cfg["model"])
    normal = [(n, s, i) for n, s, i in spec if i in ("fan_in", "embed")]
    g = torch.Generator(device=ctx.device)
    g.manual_seed(int(ctx.seed) % (2 ** 63))
    flat = torch.randn(sum(math.prod(s) for _, s, _ in normal), generator=g, device=ctx.device)
    out, at = {}, 0
    for name, shape, init in normal:
        n = math.prod(shape)
        fan = shape[1] if init == "embed" else math.prod(shape[1:])
        out[name] = flat[at:at + n].view(shape).mul_(1.0 / math.sqrt(fan))
        at += n
    for name, shape, init in spec:
        if init in ("zeros", "ones"):
            out[name] = (torch.zeros if init == "zeros" else torch.ones)(shape, device=ctx.device)
    out["decoder.embed.weight"][EOS].zero_()
    return {name: out[name] for name, _, _ in spec}


def encoder_frames() -> int:
    """Encoder frames of every Whisper window: its ``N_FRAMES`` through
    the Conv1d stem's stride 2."""
    return (ref.N_FRAMES + 1) // 2


def build(ctx: Context, overrides: Optional[dict] = None):
    """A ``Recognizer`` on the seed's weights."""
    from speech_tranformer_pytorch_tpu_torch.config import apply_overrides
    from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer

    cfg = port_config(ctx.cfg)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    params = whisper_params(ctx)
    rec = Recognizer(cfg, params, device=ctx.device)
    del params
    return rec


def check(ctx: Context, pool, items: List[dict], calls: List[int],
          control: Optional[Precision] = None) -> dict:
    """``serve.check``'s two numbers with the reference's Whisper:
    ``score_gap_mean``, the mean gap between each served score and the
    reference's score of the same tokens after the prompt under the
    suppression; ``prune_gap_mean``, the mean over the utterances of the
    widest margin by which an extension the search dropped outscores a
    hypothesis it kept (``reference/whisper.judge``). ``control``: the
    reference in that precision serves in the port's place, through its
    own beam search."""
    params = whisper_params(ctx)
    beam, alpha = ctx.mix["decode"]["beam_size"], ctx.mix["decode"]["alpha"]
    gaps, prune = [], []
    for i in calls:
        hb = pool[items[i]["batch"]]
        audio = torch.from_numpy(hb.audio).to(ctx.device)
        lens = torch.from_numpy(hb.sample_lens).to(ctx.device)
        tokens, lengths, scores = items[i]["out"]
        if control is not None:
            scores, tokens = ref.beam_search(params, ctx.cfg, audio, lens, beam, hb.max_len,
                                             alpha, control)
            lengths = torch.full(scores.shape, hb.max_len)
        judged, margins = ref.judge(params, ctx.cfg, audio, lens, tokens, lengths, alpha)
        gaps += score_gaps(scores, judged)
        prune += margins
        free_device(ctx.device)
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
    fault readings of ``calibrate_whisper.py`` and the tests)."""
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

    enc = encoder_frames()
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
            b = hb.audio.shape[0]
            items.append(dict(batch=j, wall_s=wall, audio_s=hb.seconds, steps=steps, b=b,
                              beam=decode["beam_size"], frames=[4 * enc + 3] * b,
                              enc_frames=enc, max_len=hb.max_len, out=out))
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
