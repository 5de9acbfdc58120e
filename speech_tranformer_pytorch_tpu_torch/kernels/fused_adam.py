"""Clip-scaled Adam over every leaf, in place: one launch per step.

Replaces the TPU kernel ``_adam_kernel`` / ``_update_leaf``
(speech_tranformer_pytorch_tpu/ops/fused_adam.py:46, :68), which the TPU
launched once per leaf. The kernel is ``csrc/fused_adam.cu``; its header
says what bounds it on an H100 (bytes: 20 B a parameter with bf16
moments) and how one launch walks all leaves through a device table.
``ops/fused_adam.FusedAdam`` computes the four scalars and calls
``kernels/interface.fused_adam``.
"""

from __future__ import annotations

from typing import List

import torch

from . import _build

_F32 = torch.float32


def adam_update_reference(params: List[torch.Tensor], grads: List[torch.Tensor],
                          mus: List[torch.Tensor], nus: List[torch.Tensor],
                          scalars: torch.Tensor, *, b1: float, b2: float,
                          eps: float, weight_decay: float) -> None:
    """Plain version: the kernel's f32 operations in the kernel's order,
    leaf by leaf, in place. ``scalars`` is [clip_scale, lr, c1, c2]."""
    scale, lr, c1, c2 = scalars.unbind()
    omb1, omb2 = 1.0 - b1, 1.0 - b2
    for p, g, mu, nu in zip(params, grads, mus, nus):
        g = g.float() * scale
        m = mu.float() * b1 + g * omb1
        v = nu.float() * b2 + (g * g) * omb2
        u = (m * c1) / (torch.sqrt(v * c2) + eps)
        if weight_decay:
            u = u + p * weight_decay
        p.sub_(u * lr)
        mu.copy_(m)
        nu.copy_(v)


def fused_adam_cuda(params: List[torch.Tensor], grads: List[torch.Tensor],
                    mus: List[torch.Tensor], nus: List[torch.Tensor],
                    scalars: torch.Tensor, *, b1: float, b2: float, eps: float,
                    weight_decay: float) -> None:
    """Kernel wrapper: same contract as ``adam_update_reference`` for CUDA
    tensors (f32 params and grads, f32 or bf16 moments, all contiguous)."""
    if not params or not len(params) == len(grads) == len(mus) == len(nus):
        raise ValueError("params, grads, mus and nus must be equal, non-empty lists")
    dev = params[0].device
    if dev.type != "cuda":
        raise ValueError("fused_adam_cuda needs CUDA tensors")
    mdt = mus[0].dtype
    if mdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"moment dtype {mdt} not in (float32, bfloat16)")
    rows = []
    for p, g, mu, nu in zip(params, grads, mus, nus):
        if p.dtype != _F32 or g.dtype != _F32 or mu.dtype != mdt or nu.dtype != mdt:
            raise ValueError("params and grads must be float32, moments one dtype")
        if not (p.shape == g.shape == mu.shape == nu.shape):
            raise ValueError(f"leaf shapes differ: {tuple(p.shape)}, {tuple(g.shape)}")
        for t in (p, g, mu, nu):
            if t.device != dev or not t.is_contiguous():
                raise ValueError("every leaf must be a contiguous tensor on one card")
        rows.append([p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel()])
    if scalars.shape != (4,) or scalars.dtype != _F32 or scalars.device != dev:
        raise ValueError("scalars must be a float32 [4] tensor on the card")
    # The leaf table rides to the card by a stream-ordered copy from pinned
    # memory: the host never waits.
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    lib = _build.library()
    _build.check(lib.st_fused_adam(
        table.data_ptr(), len(rows), max(r[4] for r in rows), scalars.data_ptr(),
        b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay, int(mdt == torch.bfloat16),
        _build.stream_ptr(dev)), "st_fused_adam")
    fused_adam_cuda.launches += 1


fused_adam_cuda.launches = 0
