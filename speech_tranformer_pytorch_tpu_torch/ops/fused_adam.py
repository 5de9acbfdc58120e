"""Fused Adam + global-norm clip (counterpart of the JAX package's
``ops/fused_adam.py``).

The semantics are ``optax.chain(clip_by_global_norm, adam(noam))`` with
mu and nu stored in ``moment_dtype``, computed in f32 and rounded on
store. ``global_norm_f32`` stays plain torch (one reduction shared with the
grad-norm metric). The clip scale ``clip / max(norm, clip)``, the learning
rate ``schedule(count)`` (pre-increment count, as optax's
``scale_by_schedule``) and the bias corrections at count+1 are computed on
the device into a 4-float tensor, so a step never syncs the host.
``kernels/interface.fused_adam`` then updates every leaf in place: one
launch of ``csrc/fused_adam.cu`` over all leaves on a card, the plain
version in ``kernels/fused_adam.py`` on the CPU.

With ``master_weights`` (JAX ``ops/fused_adam.py:118-227``) the model's
parameters live in the compute dtype and the f32 master lives in
``AdamState.master``: the update reads compute-dtype gradients, upcasts
them per element, updates the master and writes the parameters as the
master rounded to nearest (``kernels/interface.fused_adam_master``), so no
step casts the whole tree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from ..kernels import interface

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamState:
    """The JAX ``FusedAdamState(count, mu, nu, master)``: ``count`` is a
    device int32 scalar of completed steps; mu/nu mirror the param dict;
    ``master`` holds the f32 master parameters by name with
    ``master_weights``, else None."""
    count: torch.Tensor
    mu: Tree
    nu: Tree
    master: Optional[Tree] = None


def global_norm_f32(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ g²) with f32 accumulation."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


class FusedAdam:
    """``init`` / ``update_apply`` like the JAX ``FusedAdam``, with the
    update applied to ``params`` in place."""

    def __init__(self, schedule: Callable[[torch.Tensor], torch.Tensor], *,
                 b1: float = 0.9, b2: float = 0.98, eps: float = 1e-9,
                 grad_clip_norm: float = 5.0, weight_decay: float = 0.0,
                 moment_dtype: str = "float32", master_weights: bool = False):
        self.schedule = schedule
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.grad_clip_norm = float(grad_clip_norm or 0.0)
        self.weight_decay = float(weight_decay or 0.0)
        self.moment_dtype = getattr(torch, moment_dtype)
        self.master_weights = bool(master_weights)

    def init(self, params: Tree) -> AdamState:
        """Zero moments for the f32 tree ``params``; with ``master_weights``
        an f32 copy of it becomes the master (the model's parameters should
        then be its compute-dtype cast: ``train.create_train_state``)."""
        device = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros_like(p, dtype=self.moment_dtype)
                         for k, p in params.items()}
        master = None
        if self.master_weights:
            master = {k: p.detach().to(torch.float32, copy=True)
                      for k, p in params.items()}
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                         mu=zeros(), nu=zeros(), master=master)

    def scalars(self, grad_norm: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        """[clip_scale, lr, 1/(1-b1^t), 1/(1-b2^t)] f32 on the device, t = count+1."""
        if self.grad_clip_norm > 0:
            clip = torch.full((), self.grad_clip_norm, device=grad_norm.device)
            scale = clip / torch.maximum(grad_norm.float(), clip)
        else:
            scale = torch.ones((), device=grad_norm.device)
        t = (count + 1).float()
        c1 = 1.0 / (1.0 - torch.pow(torch.full_like(t, self.b1), t))
        c2 = 1.0 / (1.0 - torch.pow(torch.full_like(t, self.b2), t))
        lr = self.schedule(count).float()
        return torch.stack([scale, lr, c1, c2])

    def update_apply(self, grads: Tree, state: AdamState, params: Tree,
                     grad_norm: torch.Tensor = None) -> AdamState:
        """Update ``params`` and the moments (and the master) in place;
        returns the state with its count advanced. Without master weights
        ``params`` and ``grads`` are f32; with them both are in the compute
        dtype and ``params`` receives the updated master, rounded."""
        names = list(params)
        g = [grads[k] for k in names]
        if grad_norm is None:
            grad_norm = global_norm_f32(g)
        sc = self.scalars(grad_norm, state.count)
        p, mu, nu = ([t[k] for k in names] for t in (params, state.mu, state.nu))
        hyper = dict(b1=self.b1, b2=self.b2, eps=self.eps, weight_decay=self.weight_decay)
        if self.master_weights:
            if state.master is None:
                raise ValueError("master_weights needs AdamState.master "
                                 "(FusedAdam.init with master_weights=True)")
            interface.fused_adam_master(p, g, [state.master[k] for k in names],
                                        mu, nu, sc, **hyper)
        else:
            interface.fused_adam(p, g, mu, nu, sc, **hyper)
        return AdamState(count=state.count + 1, mu=state.mu, nu=state.nu,
                         master=state.master)
