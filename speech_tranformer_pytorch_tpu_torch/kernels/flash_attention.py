"""Flash attention for training: forward, dK/dV and dQ, with ragged lengths.

Replaces the TPU kernels of ``speech_tranformer_pytorch_tpu/kernels/
flash_attention.py``: ``_fa_kernel`` (:85, reached from ``_flash_fwd_bhtd``
:163), ``_fa_bwd_dkv_kernel`` (:248) and ``_fa_bwd_dq_kernel`` (:313),
both reached from ``_flash_bwd_impl`` :370. The kernels are
``csrc/flash_attention.cu``; its header says what bounds them on an H100
and how their tiles are laid out.

Semantics, shared by the kernels and their plain versions:
  * tensors are [B, H, T, D] inside (any strides, D contiguous for the
    kernels); ``interface.flash_attention`` takes [B, T, H, D];
  * key j of utterance b is kept iff ``j < kv_lengths[b]`` (and ``j <= t``
    when causal); query rows are never masked;
  * scores are scaled by 1/sqrt(D); masked scores are ``MASK_VALUE``
    (-0.7·f32 max), not -inf;
  * a row with no kept key gives o = 0, lse = m + log(max(l, 1e-37))
    (finite) and zero gradients;
  * outputs come back in the input dtype; lse and di are f32 [B, H, Tq].

``FlashAttention`` is the ``torch.autograd.Function`` that mirrors the
JAX ``custom_vjp`` (:514-532): its forward saves (q, k, v, o, lse,
kv_lengths); its backward takes di = rowsum(o·dO) in plain torch and runs
the dK/dV and dQ functions. Each of the three goes through
``kernels/interface.py``: the kernel for CUDA tensors, the plain version
here for CPU tensors. The three bf16 kernels are the Hopper design
(wgmma, a cp.async ring, softmax and accumulators in registers); they are
deterministic (no atomics), and take inputs whose rows are not 16-byte
aligned, or whose D is not a multiple of 8, through an aligned copy.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ..ops.masks import causal_mask, length_mask
from . import _build

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
MAX_HEAD_DIM = 128


def _keep_mask(tq: int, tk: int, kv_lengths: torch.Tensor, causal: bool
               ) -> torch.Tensor:
    """[B, 1, Tq, Tk] bool: the kept (query, key) pairs."""
    keep = length_mask(kv_lengths, tk)[:, None, None, :]
    if causal:
        keep = keep & causal_mask(max(tq, tk), kv_lengths.device)[None, None, :tq, :tk]
    return keep.expand(-1, 1, tq, tk)


def flash_attention_reference(q, k, v, kv_lengths, *, causal: bool
                              ) -> torch.Tensor:
    """The plain version (the JAX ``_reference_bhtd`` :497): f32 scores and
    softmax, weights rounded to v's dtype before the AV product, and rows
    with no kept key set to zero as the kernel leaves them. Differentiable
    through torch autograd."""
    d = q.shape[-1]
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) / math.sqrt(d)
    keep = _keep_mask(q.shape[2], k.shape[2], kv_lengths, causal)
    s = torch.where(keep, s, torch.full((), MASK_VALUE, device=s.device))
    p = torch.softmax(s, dim=-1) * keep.any(-1, keepdim=True)
    return torch.einsum("bhts,bhsd->bhtd", p.to(v.dtype), v)


def flash_fwd_reference(q, k, v, kv_lengths, *, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (o, lse) with the kernel's
    normalisation (o = (p in v's dtype) @ v / l, l = Σ p in f32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    keep = _keep_mask(q.shape[2], k.shape[2], kv_lengths, causal)
    s = torch.where(keep, s, torch.full((), MASK_VALUE, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), torch.zeros((), device=s.device))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhts,bhsd->bhtd", p.to(v.dtype).float(), v.float())
    l_inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    o = (acc * l_inv).to(q.dtype)
    lse = (m + torch.log(torch.clamp(l, min=1e-37)))[..., 0]
    return o, lse


def _probs(q, k, lse, kv_lengths, causal):
    """p = exp(s·scale − lse) on kept pairs, 0 elsewhere (f32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    keep = _keep_mask(q.shape[2], k.shape[2], kv_lengths, causal)
    return torch.where(keep, torch.exp(s - lse[..., None]),
                       torch.zeros((), device=s.device)), scale


def flash_bwd_dkv_reference(q, k, v, do, lse, di, kv_lengths, *, causal: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel, in f32 as the TPU kernel computes
    (``_fa_bwd_dkv_kernel``): dV = pᵀ dO, dK = (p·(dO Vᵀ − di))ᵀ q · scale."""
    p, scale = _probs(q, k, lse, kv_lengths, causal)
    dof = do.float()
    dv = torch.einsum("bhts,bhtd->bhsd", p, dof)
    dp = torch.einsum("bhtd,bhsd->bhts", dof, v.float())
    ds = p * (dp - di[..., None])
    dk = torch.einsum("bhts,bhtd->bhsd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, di, kv_lengths, *, causal: bool
                           ) -> torch.Tensor:
    """Plain version of the dQ kernel: dQ = (p·(dO Vᵀ − di)) K · scale."""
    p, scale = _probs(q, k, lse, kv_lengths, causal)
    dp = torch.einsum("bhtd,bhsd->bhts", do.float(), v.float())
    ds = p * (dp - di[..., None])
    return (torch.einsum("bhts,bhsd->bhtd", ds, k.float()) * scale).to(q.dtype)


# ---------------------------------------------------------------- kernels

def _check(name, q, k, v, kv_lengths, extra=()):
    if q.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors")
    b, h, tq, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {d} outside [1, {MAX_HEAD_DIM}]")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {q.dtype} not in (float32, bfloat16)")
    for t in (k, v) + tuple(extra):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: every input must match q's dtype and device")
    for t in (q, k, v) + tuple(extra):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
    if tuple(kv_lengths.shape) != (b,) or kv_lengths.device != q.device:
        raise ValueError(f"{name}: kv_lengths must be [{b}] on {q.device}")


def _like_bthd(x: torch.Tensor, rows: int) -> torch.Tensor:
    """An empty [B, H, rows, D] tensor stored as [B, rows, H, D]."""
    b, h, _, d = x.shape
    return torch.empty(b, rows, h, d, dtype=x.dtype, device=x.device).transpose(1, 2)


def _strides(named) -> ctypes.Array:
    """(b, h, t) strides of the eight slots q, k, v, o, dO, dq, dk, dv."""
    slots = ("q", "k", "v", "o", "do", "dq", "dk", "dv")
    arr = (ctypes.c_longlong * 24)()
    for i, slot in enumerate(slots):
        t = named.get(slot)
        if t is not None:
            arr[3 * i:3 * i + 3] = [t.stride(0), t.stride(1), t.stride(2)]
    return arr


def _vec_ok(d: int, tensors) -> int:
    """16-byte row loads are safe: D, every stride and every base pointer
    hold whole 16-byte chunks."""
    n = 16 // tensors[0].element_size()
    ok = d % n == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % n == 0 for s in t.stride()[:3])
        for t in tensors)
    return int(ok)


def _lens(kv_lengths: torch.Tensor) -> torch.Tensor:
    return kv_lengths.to(torch.int32).contiguous()


def flash_fwd_cuda(q, k, v, kv_lengths, *, causal: bool):
    """Kernel wrapper for the forward (B-4): (o, lse) for CUDA tensors. bf16
    inputs that the kernel cannot read in place are copied first
    (``_aligned_operands``)."""
    _check("flash_fwd_cuda", q, k, v, kv_lengths)
    b, h, tq, d = q.shape
    q, k, v = _aligned_operands(q, k, v)
    o = _like_bthd(q, tq)
    lse = torch.empty(b, h, tq, dtype=torch.float32, device=q.device)
    lens = _lens(kv_lengths)
    lib = _build.library()
    _build.check(lib.st_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        lens.data_ptr(), _strides(dict(q=q, k=k, v=v, o=o)), b, h, tq,
        k.shape[2], d, int(causal), int(q.dtype == torch.bfloat16),
        _vec_ok(d, (q, k, v)), _build.stream_ptr(q.device)), "st_flash_fwd")
    flash_fwd_cuda.launches += 1
    return o[..., :d], lse


def _bwd_inputs(name, q, k, v, do, lse, di, kv_lengths):
    _check(name, q, k, v, kv_lengths, extra=(do,))
    if do.shape != q.shape:
        raise ValueError(f"{name}: dO {tuple(do.shape)} != q {tuple(q.shape)}")
    b, h, tq, _ = q.shape
    for t in (lse, di):
        if tuple(t.shape) != (b, h, tq) or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse and di must be f32 [{b}, {h}, {tq}]")
    return lse.contiguous(), di.contiguous(), _lens(kv_lengths)


def _aligned_operands(*xs):
    """q, k, v (and dO) as the kernels read them. The bf16 kernels copy
    rows in 16-byte chunks with cp.async: every row must start 16-byte
    aligned and hold D rounded up to a multiple of 8 readable columns,
    zeros past D. A bf16 input that breaks this (D not a multiple of 8, a
    stride or base off the 16-byte grid) is replaced by an aligned,
    zero-padded [B, T, H, D8] copy, seen as [B, H, T, D8]; o and the
    gradients then come back in that padded width and the wrappers cut
    them to D."""
    if xs[0].dtype != torch.bfloat16:
        return xs
    d = xs[0].shape[-1]
    d8 = -(-d // 8) * 8

    def aligned(x):
        if d8 == d and _vec_ok(d, (x,)):
            return x
        b, h, t, _ = x.shape
        out = torch.zeros(b, t, h, d8, dtype=x.dtype, device=x.device).transpose(1, 2)
        out[..., :d] = x
        return out

    return tuple(aligned(x) for x in xs)


def flash_bwd_dkv_cuda(q, k, v, do, lse, di, kv_lengths, *, causal: bool):
    """Kernel wrapper for dK/dV (B-5). bf16 inputs that the kernel cannot
    read in place are copied first (``_aligned_operands``)."""
    lse, di, lens = _bwd_inputs("flash_bwd_dkv_cuda", q, k, v, do, lse, di, kv_lengths)
    b, h, tq, d = q.shape
    q, k, v, do = _aligned_operands(q, k, v, do)
    dk, dv = _like_bthd(k, k.shape[2]), _like_bthd(v, k.shape[2])
    lib = _build.library()
    _build.check(lib.st_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dk.data_ptr(), dv.data_ptr(), lens.data_ptr(),
        _strides(dict(q=q, k=k, v=v, do=do, dk=dk, dv=dv)), b, h, tq,
        k.shape[2], d, int(causal), int(q.dtype == torch.bfloat16),
        _vec_ok(d, (q, k, v, do)), _build.stream_ptr(q.device)), "st_flash_bwd_dkv")
    flash_bwd_dkv_cuda.launches += 1
    return dk[..., :d], dv[..., :d]


def flash_bwd_dq_cuda(q, k, v, do, lse, di, kv_lengths, *, causal: bool):
    """Kernel wrapper for dQ (B-6). bf16 inputs that the kernel cannot read
    in place are copied first (``_aligned_operands``)."""
    lse, di, lens = _bwd_inputs("flash_bwd_dq_cuda", q, k, v, do, lse, di, kv_lengths)
    b, h, tq, d = q.shape
    q, k, v, do = _aligned_operands(q, k, v, do)
    dq = _like_bthd(q, tq)
    lib = _build.library()
    _build.check(lib.st_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dq.data_ptr(), lens.data_ptr(),
        _strides(dict(q=q, k=k, v=v, do=do, dq=dq)), b, h, tq, k.shape[2], d,
        int(causal), int(q.dtype == torch.bfloat16), _vec_ok(d, (q, k, v, do)),
        _build.stream_ptr(q.device)), "st_flash_bwd_dq")
    flash_bwd_dq_cuda.launches += 1
    return dq[..., :d]


flash_fwd_cuda.launches = 0
flash_bwd_dkv_cuda.launches = 0
flash_bwd_dq_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """[B, H, T, D] flash attention with the recompute backward (the JAX
    ``custom_vjp``). ``apply(q, k, v, kv_lengths, causal)``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, causal: bool):
        from . import interface

        o, lse = interface.flash_fwd(q, k, v, kv_lengths, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse, kv_lengths)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        from . import interface

        q, k, v, o, lse, kv_lengths = ctx.saved_tensors
        do = do.to(q.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        # di = rowsum(o·dO) in f32, as _flash_bwd_impl takes it in jnp; an
        # lse cotangent (ring attention) would enter here as di − dlse.
        di = (o.float() * do.float()).sum(-1)
        dk, dv = interface.flash_bwd_dkv(q, k, v, do, lse, di, kv_lengths,
                                         causal=ctx.causal)
        dq = interface.flash_bwd_dq(q, k, v, do, lse, di, kv_lengths,
                                    causal=ctx.causal)
        return dq, dk, dv, None, None
