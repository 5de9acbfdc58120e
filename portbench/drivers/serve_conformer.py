"""Serving the hybrid CTC/attention Conformer (``model.encoder``
'conformer') through ``recognize.Recognizer.decode_result``: one caller,
calls back to back (a closed loop), as ``drivers/serve_ctc.py`` serves the
hybrid Transformer.

Before anything is built, every key of the configuration file must be a
field of the port's configuration (``serve_ctc.check_fields``): a port
without ``model.encoder`` would quietly serve the Transformer encoder, so
such a port exits here, within seconds and with no result. Set-up builds
the ``Recognizer`` on the seed's weights (``conformer_params``: every leaf
of ``reference/conformer.param_spec`` drawn on the device in one call,
<eos>'s row of the tied embedding zeroed as ``weights.make_params`` does,
and BatchNorm running statistics of their own draw, far from the identity,
so that a port that ignored them would fail), the mix's batches and one
call of every shape. The window serves the batches in the seed's order,
cycling, until ``--seconds`` have passed (the mix's ``trace_items`` calls
under the profiler with ``--trace 1``). Afterwards the reference judges
the hypotheses of a sample of the calls, drawn from the seed with the
longest in it, by the hybrid score and the hybrid prune over its own
Conformer (``reference/conformer.judge``).
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional

import torch

from .. import traffic
from ..harness import Context, Record, free_device, port_config, score_gaps, synchronize
from ..reference import conformer as ref
from ..reference.model import Precision
from ..trace import reduce, traced
from ..weights import EOS
from .serve import sample_calls, serve
from .serve_ctc import check_fields


def conformer_params(ctx: Context):
    """The seed's weights of every leaf ``reference/conformer.param_spec``
    lists, made on the device: the normal leaves from one draw (LeCun
    std 1/√fan-in, the embedding 1/√d, the position biases 1/√D), the
    BatchNorm means normal with std 0.3 and variances uniform in [0.5, 2]
    from a second generator."""
    m = ctx.cfg["model"]
    dev = ctx.device
    spec = ref.param_spec(m)
    normal = [(n, s, i) for n, s, i in spec if i in ("fan_in", "embed", "pos_bias")]
    g = torch.Generator(device=dev)
    g.manual_seed(int(ctx.seed) % (2 ** 63))
    flat = torch.randn(sum(math.prod(s) for _, s, _ in normal), generator=g, device=dev)
    out, at = {}, 0
    for name, shape, init in normal:
        n = math.prod(shape)
        fan = shape[1] if init in ("embed", "pos_bias") else math.prod(shape[1:])
        out[name] = flat[at:at + n].view(shape).mul_(1.0 / math.sqrt(fan))
        at += n
    g.manual_seed((int(ctx.seed) * 0x9E3779B1 + 0xB4) % (2 ** 63))
    for name, shape, init in spec:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=dev)
        elif init == "ones":
            out[name] = torch.ones(shape, device=dev)
        elif init == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=dev)
        elif init == "bn_mean":
            out[name] = 0.3 * torch.randn(shape, generator=g, device=dev)
        elif init == "bn_var":
            out[name] = 0.5 + 1.5 * torch.rand(shape, generator=g, device=dev)
    out["decoder.embed.weight"][EOS].zero_()
    return {name: out[name] for name, _, _ in spec}


def build(ctx: Context, overrides: Optional[dict] = None):
    """A ``Recognizer`` on the seed's weights."""
    from speech_tranformer_pytorch_tpu_torch.config import apply_overrides
    from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer

    cfg = port_config(ctx.cfg)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    params = conformer_params(ctx)
    rec = Recognizer(cfg, params, device=ctx.device)
    del params
    return rec


def check(ctx: Context, pool, items: List[dict], calls: List[int],
          control: Optional[Precision] = None) -> dict:
    """``serve_ctc.check``'s two numbers with the reference's Conformer:
    ``score_gap_mean`` and ``prune_gap_mean`` (``reference/conformer.judge``).
    ``control``: the reference in that precision serves in the port's
    place, through its own hybrid beam search."""
    params = conformer_params(ctx)
    d = ctx.mix["decode"]
    beam, alpha, weight = d["beam_size"], d["alpha"], ctx.cfg["decode"]["ctc_weight"]
    gaps, prune = [], []
    for i in calls:
        hb = pool[items[i]["batch"]]
        audio = torch.from_numpy(hb.audio).to(ctx.device)
        lens = torch.from_numpy(hb.sample_lens).to(ctx.device)
        tokens, lengths, scores = items[i]["out"]
        if control is not None:
            scores, tokens = ref.beam_search(params, ctx.cfg, audio, lens, beam, hb.max_len,
                                             alpha, weight, control)
            lengths = torch.full(scores.shape, hb.max_len)
        judged, margins = ref.judge(params, ctx.cfg, audio, lens, tokens, lengths, alpha,
                                    weight)
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
    fault readings of ``calibrate_conformer.py`` and the tests)."""
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
