"""Train step (counterpart of the JAX package's ``train.py``).

One step: teacher-forced forward with dropout → label-smoothed CE →
backward → global-norm clip → Adam under the Noam schedule. Mixed
precision is the JAX scheme: the f32 master parameters are cast to
``model.dtype`` once per step (``cast_params``) and the model runs on the
cast copy through ``torch.func.functional_call``; the cast's backward
brings the gradients back to f32 for the optimizer. The optimizer is
``ops/fused_adam.FusedAdam`` whatever ``train.fused_optimizer`` says: one
kernel launch over all leaves on a card, its plain version on the CPU
(the two compute the optax chain's function). Metrics stay on the device
until the caller reads them; the step never waits on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from .config import ExperimentConfig
from .device import DeviceLike, resolve_device
from .models import SpeechTransformer
from .ops.dropout import step_generator
from .ops.fused_adam import AdamState, FusedAdam, global_norm_f32
from .ops.losses import label_smoothed_cross_entropy, token_accuracy
from .ops.schedules import noam_schedule

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """``step`` counts completed steps on the host (it seeds the dropout
    generator); ``model`` holds the f32 master parameters, which the
    optimizer updates in place; ``opt`` holds the moments and the device
    step count the schedule reads."""
    step: int
    model: SpeechTransformer
    opt: AdamState

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


@dataclasses.dataclass(frozen=True)
class Batch:
    """One padded batch. ``targets_in`` is <sos>+y, ``targets_out`` is y+<eos>."""
    feats: torch.Tensor          # [B, T, F]
    frame_lens: torch.Tensor     # [B]
    targets_in: torch.Tensor     # [B, U]
    targets_out: torch.Tensor    # [B, U]
    target_lens: torch.Tensor    # [B] (length incl. the <eos>)

    def to(self, device) -> "Batch":
        return Batch(*(torch.as_tensor(getattr(self, f.name)).to(device)
                       for f in dataclasses.fields(self)))


def compute_cast_dtype(cfg: ExperimentConfig) -> Optional[torch.dtype]:
    """Dtype the f32 master parameters are cast to for compute, or None."""
    if not cfg.train.mixed_precision:
        return None
    dt = getattr(torch, cfg.model.dtype)
    return None if dt == torch.float32 else dt


def cast_params(params: Dict[str, torch.Tensor], dtype: Optional[torch.dtype]
                ) -> Dict[str, torch.Tensor]:
    """Cast every f32 leaf to ``dtype`` (None = no-op); differentiable."""
    if dtype is None:
        return params
    return {k: v.to(dtype) if v.dtype == torch.float32 else v
            for k, v in params.items()}


def make_fused_opt(cfg: ExperimentConfig) -> FusedAdam:
    t = cfg.train
    return FusedAdam(noam_schedule(cfg.model.d_model, t.warmup_steps, t.peak_lr_scale),
                     b1=t.adam_b1, b2=t.adam_b2, eps=t.adam_eps,
                     grad_clip_norm=t.grad_clip_norm, weight_decay=t.weight_decay,
                     moment_dtype=t.moment_dtype, master_weights=t.master_weights)


def create_train_state(cfg: ExperimentConfig, *, device: DeviceLike = None,
                       seed: int = 0,
                       params: Optional[Dict[str, torch.Tensor]] = None,
                       opt: Optional[AdamState] = None) -> TrainState:
    """Build the model on ``device`` (CUDA unless the caller asks for the
    CPU) with f32 master parameters: ``params`` (a state_dict, for example
    ``convert.params_from_jax``) or seeded random weights drawn on the CPU,
    so every device starts from the same weights. ``opt`` defaults to zero
    moments (``convert.adam_state_from_jax`` brings a JAX one over)."""
    dev = resolve_device(device)
    model = SpeechTransformer(cfg.model)
    if params is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(params)
    model = model.to(dev, torch.float32).train()
    if opt is None:
        opt = make_fused_opt(cfg).init(dict(model.named_parameters()))
    return TrainState(step=0, model=model, opt=opt)


def _loss_and_metrics(cfg, logits, batch) -> Tuple[torch.Tensor, Metrics]:
    loss, tokens = label_smoothed_cross_entropy(
        logits, batch.targets_out, smoothing=cfg.train.label_smoothing)
    acc = token_accuracy(logits.detach(), batch.targets_out)
    return loss, {"tokens": tokens, "accuracy": acc}


def loss_and_grads(cfg: ExperimentConfig, state: TrainState, batch: Batch,
                   seed: int) -> Tuple[Dict[str, torch.Tensor], Metrics]:
    """Forward with dropout on the compute-dtype cast of the master
    parameters, then the f32 gradients of the loss. Returns (grads by
    parameter name, metrics with loss, tokens and accuracy)."""
    drops = cfg.model.dropout_rate > 0.0 or cfg.model.attention_dropout_rate > 0.0
    gen = step_generator(seed, state.step, state.device) if drops else None
    params = state.params
    with torch.enable_grad():
        logits = functional_call(
            state.model, cast_params(params, compute_cast_dtype(cfg)),
            (batch.feats, batch.frame_lens, batch.targets_in, batch.target_lens),
            {"deterministic": False, "generator": gen})
        loss, metrics = _loss_and_metrics(cfg, logits, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
    metrics["loss"] = loss.detach()
    return dict(zip(params, grads)), metrics


def make_train_step(cfg: ExperimentConfig
                    ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``step(state, batch, seed=cfg.train.seed) -> (state, metrics)``;
    dropout bits come from a generator derived from (seed, state.step)."""
    opt = make_fused_opt(cfg)
    schedule = noam_schedule(cfg.model.d_model, cfg.train.warmup_steps,
                             cfg.train.peak_lr_scale)
    frame_s = cfg.features.frame_shift_ms / 1000.0

    def step(state: TrainState, batch: Batch,
             seed: int = cfg.train.seed) -> Tuple[TrainState, Metrics]:
        batch = batch.to(state.device)
        grads, metrics = loss_and_grads(cfg, state, batch, seed)
        grad_norm = global_norm_f32(list(grads.values()))
        lr = schedule(state.opt.count + 1)
        with torch.no_grad():
            opt_state = opt.update_apply(grads, state.opt, state.params,
                                         grad_norm=grad_norm)
        metrics.update(grad_norm=grad_norm, lr=lr,
                       audio_seconds=batch.frame_lens.sum().float() * frame_s)
        return TrainState(step=state.step + 1, model=state.model, opt=opt_state), metrics

    return step


def make_eval_step(cfg: ExperimentConfig) -> Callable[[TrainState, Batch], Metrics]:
    """Deterministic dev-loss step: ``eval_step(state, batch) -> metrics``."""
    cast_dt = compute_cast_dtype(cfg)

    @torch.no_grad()
    def step(state: TrainState, batch: Batch) -> Metrics:
        batch = batch.to(state.device)
        logits = functional_call(
            state.model, cast_params(state.params, cast_dt),
            (batch.feats, batch.frame_lens, batch.targets_in, batch.target_lens))
        loss, metrics = _loss_and_metrics(cfg, logits, batch)
        metrics["loss"] = loss
        return metrics

    return step
