"""Training through the step of ``data/pipeline.make_audio_train_step``.

Set-up builds one train state on the seed's weights (``create_train_state``)
and the mix's batches as pinned host ``AudioBatch``es at their buckets'
padded shapes. It drives that state through its first ``check_steps``
steps on the first batches of the seed's order (every row a different
utterance), keeping each step's loss, the optimizer's first moments after
step 1 and the parameters after the last; then one step of every other
(audio, target) shape of the mix. The window hands the same state the
batches in the seed's order, cycling, until ``--seconds`` have passed,
and ends at a device synchronisation: the host-to-device copy of each
batch is the step's own. With ``--trace 1`` the window is the mix's
``trace_items`` steps under the profiler. Afterwards the reference runs
the checked steps from the same weights and the numbers of
``harness.train_numbers`` are compared.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch

from .. import traffic
from ..harness import Context, Record, free_device, port_config, synchronize, train_numbers
from ..reference.model import F32, Precision
from ..reference.train import TrainBatch, run_steps
from ..trace import reduce, traced
from ..weights import make_params


def host_batches(ctx: Context, pool):
    """The port's ``AudioBatch`` of every pool batch (pinned on a card)."""
    from speech_tranformer_pytorch_tpu_torch.data.pipeline import AudioBatch

    pin = ctx.device.type == "cuda"
    out = []
    for hb in pool:
        ts = [torch.from_numpy(x) for x in (hb.audio, hb.sample_lens, hb.targets_in,
                                             hb.targets_out, hb.target_lens)]
        ts.append(torch.ones(hb.audio.shape[0], dtype=torch.bool))
        out.append(AudioBatch(*(t.pin_memory() if pin else t for t in ts)))
    return out


def reference_batches(pool, n: int) -> List[TrainBatch]:
    return [TrainBatch(*(torch.from_numpy(x) for x in (hb.audio, hb.sample_lens,
                                                       hb.targets_in, hb.targets_out,
                                                       hb.target_lens)))
            for hb in pool[:n]]


def checked_steps(ctx: Context, step_fault: Optional[Callable] = None):
    """Set-up up to the checked steps: (state, step, pool, host batches,
    the steps' losses, the first clipped gradient from the optimizer's
    moments, the parameters after the steps). ``step_fault`` wraps the
    port's step (the fault tests)."""
    from speech_tranformer_pytorch_tpu_torch.data.pipeline import make_audio_train_step
    from speech_tranformer_pytorch_tpu_torch.train import create_train_state

    cfg = port_config(ctx.cfg)
    b1 = ctx.cfg["train"]["adam_b1"]
    params = make_params(ctx.cfg["model"], ctx.seed, ctx.device)
    state = create_train_state(cfg, device=ctx.device, params=params)
    del params
    step = make_audio_train_step(cfg)
    if step_fault is not None:
        step = step_fault(step)
    ctx.mark("train state built")
    pool = traffic.build_pool(ctx.mix, ctx.cfg, ctx.seed, train=True)
    batches = host_batches(ctx, pool)
    ctx.mark("host batches made")
    cpu = lambda tree: {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in tree.items()}
    losses, grad1 = [], None
    for i in range(ctx.mix["check_steps"]):
        state, met = step(state, batches[i], ctx.seed)
        losses.append(met["loss"])
        if i == 0:
            grad1 = {k: v / (1.0 - b1) for k, v in cpu(state.opt.mu).items()}
    params_after = cpu(state.params)
    losses = [float(x) for x in losses]
    ctx.mark("checked steps run")
    return state, step, pool, batches, losses, grad1, params_after


def run(ctx: Context, *, step_fault: Optional[Callable] = None) -> Record:
    """One run. ``step_fault`` wraps the port's step (the fault tests)."""
    state, step, pool, batches, losses, grad1, params_after = checked_steps(ctx, step_fault)
    n_check = ctx.mix["check_steps"]
    seen = {hb.shape_key() for hb in pool[:n_check]}
    for hb, ab in zip(pool, batches):     # warm every other shape of the mix
        if hb.shape_key() not in seen:
            seen.add(hb.shape_key())
            state, _ = step(state, ab, ctx.seed)
            ctx.mark(f"warmed {hb.audio.shape[0]} x {hb.audio.shape[1]} samples, "
                     f"{hb.targets_in.shape[1]} targets")
    synchronize(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.mark("shapes warmed")

    items: List[dict] = []
    window_losses = []
    frames = [traffic.frames_of(hb.sample_lens, ctx.cfg["features"]).tolist() for hb in pool]
    with traced(ctx.trace, ctx.device) as box:
        t0 = time.perf_counter()
        while (len(items) < ctx.mix["trace_items"] if ctx.trace
               else time.perf_counter() - t0 < ctx.seconds):
            j = len(items) % len(pool)
            hb = pool[j]
            state, met = step(state, batches[j], ctx.seed)
            window_losses.append(met["loss"])
            items.append(dict(batch=j, audio_s=hb.seconds, b=hb.audio.shape[0],
                              frames_pad=hb.bucket,
                              frames=frames[j],
                              u_pad=hb.targets_in.shape[1],
                              target_lens=hb.target_lens.tolist()))
        synchronize(ctx.device)
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    ctx.mark(f"window: {len(items)} steps in {window_s:.3f} s")
    trace = reduce(box[0]) if box else None
    failed = int((~torch.isfinite(torch.stack(window_losses).float().cpu())).sum())
    del state, step, batches
    free_device(ctx.device)
    numbers = check(ctx, pool, losses, grad1, params_after)
    return Record(kind="train", setup_s=setup_s, window_s=window_s, items=items,
                  peak_bytes=int(peak), attempted=len(items), failed=failed,
                  numbers=numbers, trace=trace)


def check(ctx: Context, pool, losses, grad1, params_after, *,
          pr: Precision = F32, keep_rows: slice = slice(None)) -> dict:
    """The reference follows the checked steps from the seed's weights;
    ``pr``/``keep_rows`` put a control or a fault in the reference run
    that is compared with a sound one (``losses`` etc. None: the sound
    reference is the run being judged)."""
    params0 = make_params(ctx.cfg["model"], ctx.seed, ctx.device)
    batches = reference_batches(pool, ctx.mix["check_steps"])
    ref = run_steps(params0, ctx.cfg, batches, ctx.seed)
    if losses is None:
        other = run_steps(params0, ctx.cfg, batches, ctx.seed, pr=pr, keep_rows=keep_rows)
        losses, grad1, params_after = other.losses, other.first_grad, other.params
    out = train_numbers(losses, ref.losses, grad1, ref.first_grad, params0, params_after,
                        ref.params)
    del params0, ref
    free_device(ctx.device)
    return out
