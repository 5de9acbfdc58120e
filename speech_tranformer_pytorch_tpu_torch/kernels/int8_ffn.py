"""Fused int8-weight feed-forward of the decode step:
``y = relu((x @ w1q) * s1 + b1) @ w2q * s2 + b2`` in one launch.

Replaces the TPU kernel ``_kernel`` / ``int8_ffn``
(speech_tranformer_pytorch_tpu/kernels/int8_ffn.py:50, :73). On Hopper it
runs the feed-forward block of every serving decoder layer at every decode
step. The kernel is ``csrc/int8_ffn.cu``; its header says what bounds it on
an H100 (bytes: both int8 weights read once) and how the [m, ff] hidden
stays in shared memory while the per-block partial sums are reduced in a
fixed order.

Math, shared by the kernel and its plain version, at the activation's
precision (bf16 or f32 operands, f32 accumulation, f32 scales and biases
on the accumulators): the hidden layer is rounded to the operand dtype
before the second product, and the result comes back in x's dtype.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import _build

BLOCK_M = 64         # rows of x per block (csrc/int8_ffn.cu kBM)
BLOCK_FF = 128       # hidden columns per block (csrc/int8_ffn.cu kBF)
BLOCK_N = 64         # output columns per reduced chunk (csrc/int8_ffn.cu kBN)


def _check_operands(x, w1q, s1, b1, w2q, s2, b2):
    if (x.dim() != 2 or w1q.dim() != 2 or w2q.dim() != 2
            or x.shape[1] != w1q.shape[0] or w1q.shape[1] != w2q.shape[0]):
        raise ValueError(f"x {tuple(x.shape)}, w1q {tuple(w1q.shape)} and "
                         f"w2q {tuple(w2q.shape)} do not chain")
    if w1q.dtype != torch.int8 or w2q.dtype != torch.int8:
        raise ValueError("w1q and w2q must be int8")
    ff, n = w2q.shape
    for name, t, size in (("s1", s1, ff), ("b1", b1, ff), ("s2", s2, n), ("b2", b2, n)):
        if t.dtype != torch.float32 or tuple(t.shape) != (size,):
            raise ValueError(f"{name} must be float32 [{size}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x dtype {x.dtype} not in (float32, bfloat16)")


def int8_ffn_reference(x, w1q, s1, b1, w2q, s2, b2) -> torch.Tensor:
    """Plain version: [m, k] float -> [m, n] in x's dtype, with f32
    products (TF32 off on the card) and the hidden rounded to x's dtype."""
    _check_operands(x, w1q, s1, b1, w2q, s2, b2)
    h = torch.matmul(x.float(), w1q.float())
    h = torch.relu(h * s1[None, :] + b1[None, :])
    acc = torch.matmul(h.to(x.dtype).float(), w2q.float())
    return (acc * s2[None, :] + b2[None, :]).to(x.dtype)


_counters: Dict[torch.device, torch.Tensor] = {}


def _block_counters(device: torch.device, n_blocks: int) -> torch.Tensor:
    """Arrival counters, one per (row block, output chunk), zero between
    launches: the block that sums a chunk resets its counter, so one zeroed
    buffer per device serves every call (the port launches on the current
    stream only) and no launch pays for a memset."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n_blocks:
        buf = torch.zeros(max(n_blocks, 64), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def int8_ffn_cuda(x, w1q, s1, b1, w2q, s2, b2) -> torch.Tensor:
    """Kernel wrapper: same contract as ``int8_ffn_reference`` for CUDA
    tensors (x with unit column stride; the rest contiguous)."""
    _check_operands(x, w1q, s1, b1, w2q, s2, b2)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (w1q, s1, b1, w2q, s2, b2)):
        raise ValueError("int8_ffn_cuda needs CUDA tensors on one card")
    if x.stride(1) != 1:
        x = x.contiguous()
    w1q, s1, b1, w2q, s2, b2 = (t.contiguous() for t in (w1q, s1, b1, w2q, s2, b2))
    m, k = x.shape
    ff, n = w2q.shape
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    n_counters = -(-m // BLOCK_M) * -(-n // BLOCK_N)
    ff_blocks = max(-(-ff // BLOCK_FF), 1)
    partial = torch.empty((ff_blocks, m, n), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.check(lib.st_int8_ffn(
        x.data_ptr(), w1q.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2q.data_ptr(),
        s2.data_ptr(), b2.data_ptr(), out.data_ptr(), partial.data_ptr(),
        _block_counters(dev, n_counters).data_ptr(), m, k, ff, n, x.stride(0) if m > 1 else k,
        int(x.dtype == torch.bfloat16), _build.stream_ptr(dev)), "st_int8_ffn")
    int8_ffn_cuda.launches += 1
    return out


int8_ffn_cuda.launches = 0
