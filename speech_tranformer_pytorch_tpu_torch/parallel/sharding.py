"""Sharding rules and the sharded train and eval steps (counterpart of the
JAX package's ``parallel/sharding.py``).

The rules are the JAX package's (``_RULES``, the Megatron decomposition)
over the port's parameter names and ``nn.Linear`` layout ([out, in]):

  q/k/v weight [H·Dh, d]            heads (rows)         JAX P(None,'model',None)
  qkv weight [3·H·Dh, d], bias      heads of each of q, k, v
  attention out weight [d, H·Dh]    input heads (columns) JAX P('model',None,None)
  FFN fc1 weight [d_ff, d]          hidden columns (rows) JAX Dense_0 P(None,'model')
  FFN fc2 weight [d, d_ff]          hidden rows (columns) JAX Dense_1 P('model',None)
  decoder embedding [V, d]          d_model               JAX P(None,'model')
  untied out_proj [V, d]            vocabulary            JAX P(None,'model')
  everything else                   replicated

so q/k/v and fc1 biases stay whole, as JAX keeps them (the model adds
each rank's slice, ``parallel/tp.column_linear``). The port keeps every
encoder layer a module of its own, so the scanned JAX layout (a leading
layer axis kept whole, JAX ``sharding.py:60-69``) has nothing to shard
here: ``convert.py`` unstacks it. ``shard_params`` takes a full f32
``state_dict`` to one model rank's shards, ``gather_params`` brings the
shards back; the Adam moments follow the same rules (JAX
``opt_state_shardings``).

The steps mirror the JAX mesh steps, which are one GSPMD program over the
global batch: each data rank runs its rows, divides its loss sum by the
token count all-reduced over ``data`` (the global token-weighted mean,
which DDP's mean over ranks is not when ranks hold different token
counts), and sums its gradients over ``data``. The clip norm sums squares
over every shard once: a sharded leaf's squares are summed over
``model``, a replicated leaf (the same on every model rank) is counted
once. B-9 then updates this rank's shards with that one clip scale.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.func import functional_call
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..config import ExperimentConfig
from ..ops.dropout import AUGMENT_STREAM, DROPOUT_STREAM, step_generator
from ..ops.fused_adam import AdamState, global_norm_f32
from ..ops.losses import label_smoothed_ce_sums, token_accuracy_sums
from ..ops.schedules import noam_schedule
from .mesh import Mesh
from .tp import all_gather_stack

StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Shard:
    """A tensor split in ``tp`` equal blocks along ``axis``. With ``groups``
    > 1 the axis holds that many equal groups (q, k and v of a fused
    projection) and each group is split, so rank m takes heads
    m·H/tp … (m+1)·H/tp − 1 of each."""
    axis: int
    groups: int = 1


_RULES: Tuple[Tuple[str, Shard], ...] = (
    (r".*\.(self_attn|cross_attn)\.(q|k|v)\.weight$", Shard(0)),
    (r".*\.self_attn\.qkv\.(weight|bias)$", Shard(0, 3)),
    (r".*\.(self_attn|cross_attn)\.out\.weight$", Shard(1)),
    (r".*\.ffn\.fc1\.weight$", Shard(0)),
    (r".*\.ffn\.fc2\.weight$", Shard(1)),
    (r"^decoder\.embed\.weight$", Shard(1)),
    (r"^decoder\.out_proj\.weight$", Shard(0)),
)


def param_spec(name: str) -> Optional[Shard]:
    """How the parameter ``name`` is split over ``model`` (None: replicated)."""
    for pattern, spec in _RULES:
        if re.match(pattern, name):
            return spec
    return None


def shard_tensor(x: torch.Tensor, spec: Optional[Shard], tp: int, m: int) -> torch.Tensor:
    """Model rank ``m``'s block of the whole tensor ``x``, in storage of
    its own (the optimizer updates shards in place)."""
    if spec is None:
        return x.clone()
    g = x.unflatten(spec.axis, (spec.groups, -1))
    block = g.chunk(tp, dim=spec.axis + 1)[m].flatten(spec.axis, spec.axis + 1)
    return block.clone(memory_format=torch.contiguous_format)


def merge_shards(parts: List[torch.Tensor], spec: Optional[Shard]) -> torch.Tensor:
    """The whole tensor from every model rank's block, in rank order."""
    if spec is None:
        return parts[0]
    grouped = [p.unflatten(spec.axis, (spec.groups, -1)) for p in parts]
    return torch.cat(grouped, dim=spec.axis + 1).flatten(spec.axis, spec.axis + 1)


def shard_params(state_dict: StateDict, tp: int, m: int) -> StateDict:
    """Model rank ``m``'s shards of a whole ``state_dict`` (every data rank
    holds the same)."""
    return {k: shard_tensor(v, param_spec(k), tp, m) for k, v in state_dict.items()}


def gather_params(local: StateDict, mesh: Mesh) -> StateDict:
    """The whole ``state_dict`` from this rank's shards: an all-gather over
    ``model`` for every sharded leaf. Every model rank must call it."""
    out = {}
    for k, v in local.items():
        spec = param_spec(k)
        if spec is None:
            out[k] = v
            continue
        parts = all_gather_stack(v, mesh.model_group, mesh.tp)
        out[k] = merge_shards(list(parts.unbind(0)), spec)
    return out


def shard_adam_state(opt: AdamState, tp: int, m: int, device=None) -> AdamState:
    """The moments (and master) follow the parameters' rules; the count is
    replicated. ``device``: where the shards go."""
    def part(tree):
        if tree is None:
            return None
        return {k: v.to(device) for k, v in shard_params(tree, tp, m).items()}

    return AdamState(count=opt.count.to(device), mu=part(opt.mu), nu=part(opt.nu),
                     master=part(opt.master))


def gather_adam_state(opt: AdamState, mesh: Mesh) -> AdamState:
    master = None if opt.master is None else gather_params(opt.master, mesh)
    return AdamState(count=opt.count, mu=gather_params(opt.mu, mesh),
                     nu=gather_params(opt.nu, mesh), master=master)


def data_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This data rank's contiguous block of the leading (batch) axis, as
    JAX's ``P('data')`` places it; the batch must divide the data axis."""
    if x.shape[0] % mesh.dp != 0:
        raise ValueError(f"batch {x.shape[0]} does not divide the data axis {mesh.dp}")
    return x.chunk(mesh.dp, dim=0)[mesh.data_index]


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data ranks' equal blocks of the leading axis, concatenated in
    data order (the inverse of ``data_rows``)."""
    return all_gather_stack(x, mesh.data_group, mesh.dp).flatten(0, 1)


def all_reduce_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x, group=mesh.data_group)
    return x


def sum_grads_over_data(grads: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Gradients summed over ``data``: one all-reduce of a flat buffer."""
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=mesh.data_group)
    return list(_unflatten_dense_tensors(flat, grads))


def sharded_global_norm(grads: Dict[str, torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """sqrt(Σ g²) over the whole gradient tree from this rank's shards: a
    sharded leaf's squares are summed over ``model``, a replicated leaf is
    counted once (it is the same on every model rank). With one model rank
    every leaf is whole: the single-device norm, in its summation order."""
    if mesh.tp == 1:
        return global_norm_f32(list(grads.values()))
    names = list(grads)
    norms = torch._foreach_norm([grads[k].float() for k in names])
    sharded = [n for k, n in zip(names, norms) if param_spec(k) is not None]
    replicated = [n for k, n in zip(names, norms) if param_spec(k) is None]
    zero = torch.zeros((), device=norms[0].device)
    sq_sharded = torch.stack(sharded).square().sum() if sharded else zero
    sq_sharded = sq_sharded.clone()
    dist.all_reduce(sq_sharded, group=mesh.model_group)
    sq_rep = torch.stack(replicated).square().sum() if replicated else zero
    return torch.sqrt(sq_sharded + sq_rep)


def _global_loss(cfg: ExperimentConfig, logits, targets, mesh: Mesh):
    """(this rank's share of the global mean loss, global tokens, global
    accuracy): the local sums over the all-reduced token count."""
    loss_sum, weights = label_smoothed_ce_sums(logits, targets,
                                               smoothing=cfg.train.label_smoothing)
    tokens = torch.clamp(all_reduce_data(weights.detach(), mesh), min=1.0)
    correct = all_reduce_data(token_accuracy_sums(logits.detach(), targets), mesh)
    return loss_sum / tokens, tokens, correct / tokens


def make_sharded_audio_train_step(cfg: ExperimentConfig, mesh: Mesh):
    """``step(state, audio_batch, seed=cfg.train.seed) -> (state, metrics)``
    on this rank's rows (``data_rows`` of the global batch, or a
    ``BucketedBatcher`` shard) and its parameter shards: on-device fbank
    (B-1) → SpecAugment → the TP model → the global loss → gradients summed
    over ``data`` → the sharded clip norm → B-9 on this rank's shards. The
    metrics are the global ones, equal on every rank."""
    from ..data.pipeline import make_preprocess_fn
    from ..train import cast_params, compute_cast_dtype, make_fused_opt

    if cfg.train.master_weights:
        raise ValueError("train.master_weights is single-device only (as in the "
                         "JAX package): turn it off for mesh training")
    preprocess = make_preprocess_fn(cfg.features, cfg.spec_augment)
    opt = make_fused_opt(cfg)
    schedule = noam_schedule(cfg.model.d_model, cfg.train.warmup_steps,
                             cfg.train.peak_lr_scale)
    cast_dt = compute_cast_dtype(cfg)
    frame_s = cfg.features.frame_shift_ms / 1000.0
    drops = cfg.model.dropout_rate > 0.0 or cfg.model.attention_dropout_rate > 0.0
    augment = cfg.spec_augment.enabled

    def step(state, abatch, seed: int = cfg.train.seed):
        # Data rank 0 draws the single-device bits; the model ranks of one
        # data index draw the same bits, so replicated activations stay
        # equal across them, and a sharded activation keeps its block of
        # the whole tensor's bits (ops/dropout.py).
        aug = (step_generator(seed, state.step, mesh.device, AUGMENT_STREAM,
                              shard=mesh.data_index) if augment else None)
        batch = preprocess(abatch, mesh.device, aug)
        gen = (step_generator(seed, state.step, mesh.device, DROPOUT_STREAM,
                              shard=mesh.data_index) if drops else None)
        params = state.params
        with torch.enable_grad():
            logits = functional_call(
                state.model, cast_params(params, cast_dt),
                (batch.feats, batch.frame_lens, batch.targets_in, batch.target_lens),
                {"deterministic": False, "generator": gen})
            loss, tokens, acc = _global_loss(cfg, logits, batch.targets_out, mesh)
            grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, sum_grads_over_data(list(grads), mesh)))
        grad_norm = sharded_global_norm(grads, mesh)
        lr = schedule(state.opt.count + 1)
        with torch.no_grad():
            opt_state = opt.update_apply(grads, state.opt, params, grad_norm=grad_norm)
        audio_s = all_reduce_data(batch.frame_lens.sum().float() * frame_s, mesh)
        metrics = {"loss": all_reduce_data(loss.detach(), mesh), "tokens": tokens,
                   "accuracy": acc, "grad_norm": grad_norm, "lr": lr,
                   "audio_seconds": audio_s}
        return dataclasses.replace(state, step=state.step + 1, opt=opt_state), metrics

    return step


def make_sharded_audio_eval_step(cfg: ExperimentConfig, mesh: Mesh):
    """``eval_step(state, audio_batch) -> {"loss", "tokens"}`` on this
    rank's rows: the global deterministic dev loss, padding rows
    (``valid=False``) given no weight, as the single-device eval step."""
    from ..data.pipeline import make_preprocess_fn
    from ..data.tokenizer import PAD
    from ..train import cast_params, compute_cast_dtype

    preprocess = make_preprocess_fn(cfg.features, None)
    cast_dt = compute_cast_dtype(cfg)

    @torch.no_grad()
    def step(state, abatch):
        batch = preprocess(abatch, mesh.device)
        logits = functional_call(
            state.model, cast_params(state.params, cast_dt),
            (batch.feats, batch.frame_lens, batch.targets_in, batch.target_lens))
        valid = torch.as_tensor(abatch.valid).to(mesh.device)
        tgt = torch.where(valid[:, None], batch.targets_out, PAD)
        loss, tokens, _ = _global_loss(cfg, logits, tgt, mesh)
        return {"loss": all_reduce_data(loss, mesh), "tokens": tokens}

    return step
