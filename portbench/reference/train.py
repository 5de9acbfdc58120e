"""The first train steps of the reference.

One step: fbank + CMVN, SpecAugment when the configuration enables it,
the teacher-forced forward with dropout, the label-smoothed cross-entropy
(smoothing eps: (1 - eps) on the target, eps / (V - 1) on each other
class; padding targets weigh 0; mean over the valid tokens), the backward
pass, clipping by the global norm, and Adam under the Noam schedule
(learning rate scale * d_model^-0.5 * min(c^-0.5, c * warmup^-1.5) at the
count c before the step, floored at 1; bias corrections at c + 1; moments
computed in float32 and stored in the configured moment dtype).

The batch runs in blocks of rows, so that a float32 step at the timed
sizes fits beside nothing else; the mean loss divides by the whole batch's
token count, so the blocks' gradients add up to the whole batch's. The
SpecAugment draws and the dropout bytes come from generators seeded from
(seed, step) by ``model.step_generator``: SpecAugment on stream 1 (four
integer draws: frequency widths in [0, 10000), frequency starts, time
widths in [0, 10000), time starts), dropout on stream 0, site by site.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import torch

from .frontend import fbank, spec_augment_keep
from .model import (F32, Dropout, Precision, decode, draw_dropout_bits, dropout_shapes,
                    encode, exact_float32, step_generator, subsampled)

RAW_WIDTH = 10_000
PAD = 0


class TrainBatch(NamedTuple):
    audio: torch.Tensor         # [B, S] int16
    sample_lens: torch.Tensor   # [B]
    targets_in: torch.Tensor    # [B, U] <sos> + y
    targets_out: torch.Tensor   # [B, U] y + <eos>
    target_lens: torch.Tensor   # [B]


class Steps(NamedTuple):
    losses: List[float]                       # each step's mean loss
    first_grad: Dict[str, torch.Tensor]       # the clipped gradient of step 1
    params: Dict[str, torch.Tensor]           # the parameters after the steps


def smoothed_ce_sum(logits: torch.Tensor, targets: torch.Tensor, eps: float) -> torch.Tensor:
    lp = torch.log_softmax(logits, dim=-1)
    true = torch.gather(lp, -1, targets.long()[..., None])[..., 0]
    off = lp.sum(-1) - true
    v = logits.shape[-1]
    per = -((1.0 - eps) * true + eps / (v - 1) * off) if eps > 0 else -true
    return (per * (targets != PAD).float()).sum()


def noam(c: int, d_model: int, warmup: int, scale: float) -> float:
    c = max(float(c), 1.0)
    return scale * d_model ** -0.5 * min(c ** -0.5, c * warmup ** -1.5)


def block_rows(m: dict, t_sub: int, budget_bytes: float = 6e9) -> int:
    """Rows a block so that the encoder's float32 attention weights kept
    for the backward stay within ``budget_bytes``."""
    per_row = 3 * 4 * m["num_heads"] * t_sub * t_sub * m["num_encoder_layers"]
    return max(1, int(budget_bytes // max(per_row, 1)))


def grads_of_batch(params, cfg: dict, batch: TrainBatch, seed: int, step: int,
                   pr: Precision = F32, keep_rows: slice = slice(None)):
    """(mean loss, gradients) of one step's batch. ``keep_rows`` takes the
    loss over some rows only (a fault of the control test: half the batch
    left out)."""
    m, t = cfg["model"], cfg["train"]
    dev = params["decoder.embed.weight"].device
    audio = batch.audio.to(dev)
    feats, frame_lens = fbank(audio, batch.sample_lens.to(dev), cfg["features"])
    b, frames, bins = feats.shape
    s = cfg["spec_augment"]
    if s["enabled"]:
        g = step_generator(seed, step, dev, stream=1)
        draw = lambda high, n: torch.randint(0, high, (b, n), generator=g, device=dev)
        draws = (draw(RAW_WIDTH, s["num_freq_masks"]), draw(bins, s["num_freq_masks"]),
                 draw(RAW_WIDTH, s["num_time_masks"]), draw(frames, s["num_time_masks"]))
        keep_f, keep_t = spec_augment_keep(draws, frame_lens, frames, bins, s)
        feats = feats * keep_f[:, None, :].float() * keep_t[:, :, None].float()
    tin, tout = batch.targets_in.to(dev), batch.targets_out.to(dev)
    tlens = batch.target_lens.to(dev)
    t_sub, u = subsampled(frames), tin.shape[1]
    rate = m["dropout_rate"]
    bits = (draw_dropout_bits(step_generator(seed, step, dev), dropout_shapes(m, b, t_sub, u))
            if rate > 0 else None)
    rows = torch.arange(b, device=dev)[keep_rows]
    count = torch.clamp((tout[rows] != PAD).float().sum(), min=1.0)
    names = list(params)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    loss = torch.zeros((), device=dev, dtype=torch.float64)
    step_rows = block_rows(m, t_sub)
    for lo in range(0, len(rows), step_rows):
        r = rows[lo:lo + step_rows]
        drop = Dropout(rate, bits, r)
        with torch.enable_grad():
            p = {k: v.detach().requires_grad_() for k, v in params.items()}
            mem, mem_lens = encode(p, m, feats[r], frame_lens[r], drop=drop, pr=pr)
            logits = decode(p, m, tin[r], tlens[r], mem, mem_lens, drop=drop, pr=pr)
            part = smoothed_ce_sum(logits, tout[r], t["label_smoothing"]) / count
            gs = torch.autograd.grad(part, [p[k] for k in names])
        for k, gk in zip(names, gs):
            grads[k] += gk
        loss += part.detach().double()
    return float(loss), grads


@torch.no_grad()
def adam_step(params, grads, mu, nu, count: int, cfg: dict):
    """Clip by the global norm, then one Adam update in place; returns the
    clipped gradients."""
    t, m = cfg["train"], cfg["model"]
    norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
    clip = t["grad_clip_norm"]
    scale = clip / max(norm, clip) if clip > 0 else 1.0
    b1, b2, eps = t["adam_b1"], t["adam_b2"], t["adam_eps"]
    lr = noam(count, m["d_model"], t["warmup_steps"], t["peak_lr_scale"])
    c1, c2 = 1.0 / (1.0 - b1 ** (count + 1)), 1.0 / (1.0 - b2 ** (count + 1))
    clipped = {}
    for k, p in params.items():
        g = grads[k] * scale
        mk = mu[k].float() * b1 + g * (1.0 - b1)
        vk = nu[k].float() * b2 + g * g * (1.0 - b2)
        u = (mk * c1) / (torch.sqrt(vk * c2) + eps)
        if t["weight_decay"]:
            u = u + p * t["weight_decay"]
        p -= lr * u
        mu[k].copy_(mk)
        nu[k].copy_(vk)
        clipped[k] = g
    return clipped


def run_steps(params0, cfg: dict, batches: Sequence[TrainBatch], seed: int,
              pr: Precision = F32, keep_rows: slice = slice(None)) -> Steps:
    """The reference's first ``len(batches)`` steps from ``params0``."""
    mdt = getattr(torch, cfg["train"]["moment_dtype"])
    params = {k: v.detach().clone().float() for k, v in params0.items()}
    mu = {k: torch.zeros_like(v, dtype=mdt) for k, v in params.items()}
    nu = {k: torch.zeros_like(v, dtype=mdt) for k, v in params.items()}
    losses, first = [], None
    with exact_float32():
        for step, batch in enumerate(batches):
            loss, grads = grads_of_batch(params, cfg, batch, seed, step, pr, keep_rows)
            clipped = adam_step(params, grads, mu, nu, step, cfg)
            losses.append(loss)
            if first is None:
                first = clipped
            del grads
    return Steps(losses, first, params)
