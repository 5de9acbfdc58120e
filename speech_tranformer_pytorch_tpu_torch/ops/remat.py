"""Layer rematerialisation (counterpart of the JAX package's ``nn.remat`` /
``jax.checkpoint``) that keeps the port's explicit dropout generators exact.

``torch.utils.checkpoint`` restores only the default CPU and CUDA
generators, while every dropout byte of the port comes from an explicit
``torch.Generator`` (``ops/dropout.py``). A plain wrap would draw other
masks in the recompute and give silently wrong gradients. ``remat``
snapshots the generator's state (host-side seed and offset: no device
sync) before the forward, lets the forward advance the caller's generator
as usual, and hands the recompute a fresh generator set to the snapshot,
so it draws the forward's bits. Non-reentrant checkpointing keeps the
forward's autograd graph and only recomputes the saved tensors, so the
gradients equal those of the unwrapped call bit for bit wherever the
recompute is deterministic.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint


def remat(fn: Callable, *args, generator: Optional[torch.Generator] = None):
    """``fn(*args, generator=g)`` under ``torch.utils.checkpoint``, with
    ``g`` the caller's generator in the forward and its snapshot in the
    recompute. The port draws nothing from the default generators, so
    checkpoint's own RNG stash is off."""
    snapshot = None if generator is None else generator.get_state()
    calls = [0]

    def run(*a):
        g = generator
        if calls[0] and generator is not None:
            g = torch.Generator(device=generator.device)
            g.set_state(snapshot)
        calls[0] += 1
        return fn(*a, generator=g)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def remat_module(module: torch.nn.Module, *args,
                 generator: Optional[torch.Generator] = None, **kwargs):
    """``module(*args, generator=..., **kwargs)`` under ``remat``. The
    module's current parameters enter as explicit inputs: under the train
    step's ``functional_call`` they are the compute-dtype copies, which the
    module no longer holds when the backward recomputes."""
    names, tensors = zip(*module.named_parameters())
    n = len(args)

    def fn(*flat, generator):
        return functional_call(module, dict(zip(names, flat[n:])), flat[:n],
                               dict(kwargs, generator=generator))

    return remat(fn, *args, *tensors, generator=generator)
