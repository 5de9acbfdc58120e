"""Clip-scaled Adam over every leaf, in place: one launch per step.

Replaces the TPU kernel ``_adam_kernel`` / ``_update_leaf``
(speech_tranformer_pytorch_tpu/ops/fused_adam.py:46, :68), which the TPU
launched once per leaf. The kernel is ``csrc/fused_adam.cu``; its header
says what bounds it on an H100 (bytes: 20 B a parameter with bf16
moments) and how one launch walks all leaves through a device table.
``ops/fused_adam.FusedAdam`` computes the four scalars and calls
``kernels/interface.fused_adam``.

``fused_adam_master_cuda`` is the master-weights variant (JAX ``updm``,
ops/fused_adam.py:199-210, which the TPU runs through XLA): bf16 gradients
and parameters, an f32 master, one launch a step. Its launches are
counted apart from the classic kernel's.
"""

from __future__ import annotations

from typing import List

import torch

from . import _build

_F32 = torch.float32


def _adam_leaf(w, g, mu, nu, scalars, b1, b2, eps, weight_decay) -> None:
    """One leaf of the update, in place on the f32 weight ``w`` and the
    moments: the kernel's f32 operations in the kernel's order."""
    scale, lr, c1, c2 = scalars.unbind()
    g = g.float() * scale
    m = mu.float() * b1 + g * (1.0 - b1)
    v = nu.float() * b2 + (g * g) * (1.0 - b2)
    u = (m * c1) / (torch.sqrt(v * c2) + eps)
    if weight_decay:
        u = u + w * weight_decay
    w.sub_(u * lr)
    mu.copy_(m)
    nu.copy_(v)


def adam_update_reference(params: List[torch.Tensor], grads: List[torch.Tensor],
                          mus: List[torch.Tensor], nus: List[torch.Tensor],
                          scalars: torch.Tensor, *, b1: float, b2: float,
                          eps: float, weight_decay: float) -> None:
    """Plain version: the kernel's f32 operations in the kernel's order,
    leaf by leaf, in place. ``scalars`` is [clip_scale, lr, c1, c2]."""
    for p, g, mu, nu in zip(params, grads, mus, nus):
        _adam_leaf(p, g, mu, nu, scalars, b1, b2, eps, weight_decay)


def adam_update_master_reference(params: List[torch.Tensor], grads: List[torch.Tensor],
                                 masters: List[torch.Tensor], mus: List[torch.Tensor],
                                 nus: List[torch.Tensor], scalars: torch.Tensor, *,
                                 b1: float, b2: float, eps: float,
                                 weight_decay: float) -> None:
    """Plain version of the master variant: the same update against the f32
    ``masters`` (compute-dtype ``grads`` upcast per element, weight decay on
    the master), then each parameter set to its master rounded to nearest."""
    for p, g, w, mu, nu in zip(params, grads, masters, mus, nus):
        _adam_leaf(w, g, mu, nu, scalars, b1, b2, eps, weight_decay)
        p.copy_(w)


def fused_adam_cuda(params: List[torch.Tensor], grads: List[torch.Tensor],
                    mus: List[torch.Tensor], nus: List[torch.Tensor],
                    scalars: torch.Tensor, *, b1: float, b2: float, eps: float,
                    weight_decay: float) -> None:
    """Kernel wrapper: same contract as ``adam_update_reference`` for CUDA
    tensors (f32 params and grads, f32 or bf16 moments, all contiguous)."""
    if not params or not len(params) == len(grads) == len(mus) == len(nus):
        raise ValueError("params, grads, mus and nus must be equal, non-empty lists")
    dev, mdt = params[0].device, mus[0].dtype
    rows = []
    for p, g, mu, nu in zip(params, grads, mus, nus):
        if p.dtype != _F32 or g.dtype != _F32 or mu.dtype != mdt or nu.dtype != mdt:
            raise ValueError("params and grads must be float32, moments one dtype")
        _check_leaf(dev, p, g, mu, nu)
        rows.append([p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel()])
    _launch("st_fused_adam", rows, scalars, dev, mdt, b1, b2, eps, weight_decay)
    fused_adam_cuda.launches += 1


def fused_adam_master_cuda(params: List[torch.Tensor], grads: List[torch.Tensor],
                           masters: List[torch.Tensor], mus: List[torch.Tensor],
                           nus: List[torch.Tensor], scalars: torch.Tensor, *,
                           b1: float, b2: float, eps: float, weight_decay: float) -> None:
    """Kernel wrapper of the master variant: same contract as
    ``adam_update_master_reference`` for CUDA tensors (bf16 params and
    grads, f32 masters, f32 or bf16 moments, all contiguous)."""
    leaves = list(zip(params, grads, masters, mus, nus))
    if not leaves or not len(leaves) == len(params) == len(grads) == len(mus) == len(nus):
        raise ValueError("params, grads, masters, mus and nus must be equal, "
                         "non-empty lists")
    dev, mdt = params[0].device, mus[0].dtype
    rows = []
    for p, g, w, mu, nu in leaves:
        if (p.dtype != torch.bfloat16 or g.dtype != torch.bfloat16 or w.dtype != _F32
                or mu.dtype != mdt or nu.dtype != mdt):
            raise ValueError("params and grads must be bfloat16, masters float32, "
                             "moments one dtype")
        _check_leaf(dev, p, g, w, mu, nu)
        rows.append([p.data_ptr(), g.data_ptr(), w.data_ptr(), mu.data_ptr(),
                     nu.data_ptr(), p.numel()])
    _launch("st_fused_adam_master", rows, scalars, dev, mdt, b1, b2, eps, weight_decay)
    fused_adam_master_cuda.launches += 1


def _check_leaf(dev, *ts) -> None:
    if not all(t.shape == ts[0].shape for t in ts):
        raise ValueError(f"leaf shapes differ: {[tuple(t.shape) for t in ts]}")
    for t in ts:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("every leaf must be a contiguous tensor on one card")


def _launch(fn: str, rows, scalars, dev, mdt, b1, b2, eps, weight_decay) -> None:
    """One launch over the leaf table ``rows`` (numel last in each row)."""
    if dev.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors")
    if mdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"moment dtype {mdt} not in (float32, bfloat16)")
    if scalars.shape != (4,) or scalars.dtype != _F32 or scalars.device != dev:
        raise ValueError("scalars must be a float32 [4] tensor on the card")
    # The leaf table rides to the card by a stream-ordered copy from pinned
    # memory: the host never waits.
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    lib = _build.library()
    _build.check(getattr(lib, fn)(
        table.data_ptr(), len(rows), max(r[-1] for r in rows), scalars.data_ptr(),
        b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay, int(mdt == torch.bfloat16),
        _build.stream_ptr(dev)), fn)


fused_adam_cuda.launches = 0
fused_adam_master_cuda.launches = 0
