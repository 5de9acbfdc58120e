"""Train step (counterpart of the JAX package's ``train.py``).

One step: teacher-forced forward with dropout → label-smoothed CE →
backward → global-norm clip → Adam under the Noam schedule. With
``train.ctc_weight`` w > 0 (a model with ``model.ctc_head``) the loss is
the hybrid CTC/attention one, (1 − w)·CE + w·CTC, the CTC loss summed over
the batch and taken over the CE's token count, as the CE is. Mixed
precision is the JAX scheme: the f32 master parameters are cast to
``model.dtype`` once per step (``cast_params``) and the model runs on the
cast copy through ``torch.func.functional_call``; the cast's backward
brings the gradients back to f32 for the optimizer. The optimizer is
``ops/fused_adam.FusedAdam`` whatever ``train.fused_optimizer`` says: one
kernel launch over all leaves on a card, its plain version on the CPU
(the two compute the optax chain's function). That is a standing
difference by design, recorded in ROADMAP section C and held against both
JAX optimizers by ``tests/test_torch_train.py::test_f32_step_matches_jax``.
With ``train.master_weights``
(JAX ``train.py:244-267``) the model holds its parameters in
``model.dtype`` and the f32 master lives in ``AdamState.master``: no step
casts the tree, the gradients stay in the compute dtype and the
optimizer's master variant writes the rounded master back into the model.
Metrics stay on the device until the caller reads them; the step never
waits on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from .config import ExperimentConfig, serving_only_fields
from .device import DeviceLike, resolve_device
from .models import SpeechTransformer
from .ops.dropout import step_generator
from .ops.fused_adam import AdamState, FusedAdam, global_norm_f32
from .ops.losses import ctc_loss_sum, label_smoothed_cross_entropy, token_accuracy
from .ops.schedules import noam_schedule

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """``step`` counts completed steps on the host (it seeds the dropout
    and SpecAugment generators); ``model`` holds the f32 master parameters
    (with ``train.master_weights``: their compute-dtype cast), which the
    optimizer updates in place; ``opt`` holds the moments, the device step
    count the schedule reads and, with master weights, the master."""
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
                       opt: Optional[AdamState] = None, mesh=None) -> TrainState:
    """Build the model on ``device`` (CUDA unless the caller asks for the
    CPU) with f32 master parameters: ``params`` (a state_dict, for example
    ``convert.params_from_jax``) or seeded random weights drawn on the CPU,
    so every device starts from the same weights. ``opt`` defaults to zero
    moments (``convert.adam_state_from_jax`` brings a JAX one over). With
    ``train.master_weights`` a default ``opt`` takes the f32 parameters as
    its master and the model is cast to ``model.dtype``; a given ``opt``
    must carry its master.

    With a ``mesh`` (``parallel.mesh.Mesh``) the state is this rank's
    tensor-parallel shards on the mesh's device: the whole model is built
    (or loaded) on the CPU, then ``parallel/sharding.shard_params`` takes
    its shards, and a given whole ``opt`` is sharded the same way.
    ``train.master_weights`` is single-device only, as in JAX."""
    only = serving_only_fields(cfg)
    if only:
        raise ValueError(f"{only} are served by the beam search alone: the port has no "
                         f"training path for them (the reference trains none of them)")
    dev = resolve_device(device) if mesh is None else mesh.device
    model = SpeechTransformer(cfg.model)
    if params is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(params)
    if mesh is not None:
        from .parallel.sharding import shard_adam_state, shard_params

        if cfg.train.master_weights:
            raise ValueError("train.master_weights is single-device only (as in "
                             "the JAX package): turn it off for mesh training")
        whole = model.state_dict()
        model = SpeechTransformer(cfg.model, mesh)
        model.load_state_dict(shard_params(whole, mesh.tp, mesh.model_index))
        if opt is not None:
            opt = shard_adam_state(opt, mesh.tp, mesh.model_index, device=dev)
    model = model.to(dev, torch.float32).train()
    if opt is None:
        opt = make_fused_opt(cfg).init(dict(model.named_parameters()))
    if cfg.train.master_weights:
        dt = compute_cast_dtype(cfg)
        if opt.master is None or dt is None:
            raise ValueError("train.master_weights needs mixed precision with a "
                             "non-f32 model.dtype and an optimizer state with "
                             "its f32 master")
        model = model.to(dt)
    return TrainState(step=0, model=model, opt=opt)


def _forward_kw(cfg: ExperimentConfig) -> dict:
    """The model's forward also returns the CTC log-probs when the loss
    weighs them in."""
    return {"ctc": True} if cfg.train.ctc_weight > 0.0 else {}


def _loss_and_metrics(cfg, out, batch) -> Tuple[torch.Tensor, Metrics]:
    """``out``: the forward's logits, or with ``_forward_kw``'s ``ctc``
    (logits, CTC log-probs, encoder lengths)."""
    logits = out[0] if isinstance(out, tuple) else out
    loss, tokens = label_smoothed_cross_entropy(
        logits, batch.targets_out, smoothing=cfg.train.label_smoothing)
    metrics = {"tokens": tokens, "accuracy": token_accuracy(logits.detach(), batch.targets_out)}
    w = cfg.train.ctc_weight
    if w > 0.0:   # the labels are targets_out without its <eos>
        _, log_probs, enc_lens = out
        ctc = ctc_loss_sum(log_probs, enc_lens, batch.targets_out, batch.target_lens - 1) / tokens
        metrics.update(att_loss=loss.detach(), ctc_loss=ctc.detach())
        loss = (1.0 - w) * loss + w * ctc
    return loss, metrics


def loss_and_grads(cfg: ExperimentConfig, state: TrainState, batch: Batch,
                   seed: int) -> Tuple[Dict[str, torch.Tensor], Metrics]:
    """Forward with dropout on the compute-dtype cast of the master
    parameters, then the f32 gradients of the loss (with master weights:
    on the model's compute-dtype parameters themselves, and gradients in
    that dtype). Returns (grads by parameter name, metrics with loss,
    tokens and accuracy)."""
    drops = cfg.model.dropout_rate > 0.0 or cfg.model.attention_dropout_rate > 0.0
    gen = step_generator(seed, state.step, state.device) if drops else None
    params = state.params
    compute = params if cfg.train.master_weights else cast_params(
        params, compute_cast_dtype(cfg))
    with torch.enable_grad():
        out = functional_call(
            state.model, compute,
            (batch.feats, batch.frame_lens, batch.targets_in, batch.target_lens),
            {"deterministic": False, "generator": gen, **_forward_kw(cfg)})
        loss, metrics = _loss_and_metrics(cfg, out, batch)
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
        out = functional_call(
            state.model, cast_params(state.params, cast_dt),
            (batch.feats, batch.frame_lens, batch.targets_in, batch.target_lens),
            _forward_kw(cfg))
        loss, metrics = _loss_and_metrics(cfg, out, batch)
        metrics["loss"] = loss
        return metrics

    return step
