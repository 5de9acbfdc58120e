"""Int8-weight matmul of the decode step: ``y = (x @ wq) * scale``.

Replaces the TPU kernel ``_kernel`` / ``int8_matmul``
(speech_tranformer_pytorch_tpu/kernels/int8_matmul.py:52, :61). On Hopper
it runs every int8 dense layer of the serving decoder: the four attention
projections of each decode step and the cross K/V projections of
``init_cache``. The kernel is ``csrc/int8_matmul.cu``; its header says
what bounds it on an H100 (bytes: the int8 weight read once) and how the
int8 tile is converted after the load, so the weight stream stays int8.

Math, shared by the kernel and its plain version, at the activation's
precision: bf16 x gives bf16 operands (int8 values are exact in bf16),
f32 x gives f32 operands; f32 accumulation; the f32 per-column scale
multiplies the accumulator; the result comes back in x's dtype.
"""

from __future__ import annotations

import torch

from . import _build


def _check_operands(x, wq, scale):
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and wq {tuple(wq.shape)} do not chain")
    if wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"wq must be int8 and scale float32, got {wq.dtype}, "
                         f"{scale.dtype}")
    if tuple(scale.shape) != (wq.shape[1],):
        raise ValueError(f"scale {tuple(scale.shape)} for {wq.shape[1]} columns")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x dtype {x.dtype} not in (float32, bfloat16)")


def int8_matmul_reference(x: torch.Tensor, wq: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """Plain version: [m, k] float x [k, n] int8 -> [m, n] in x's dtype.
    Operands upcast to f32 (bf16 x and int8 values are exact there), one
    f32 product, the scale on the f32 result, one rounding at the end."""
    _check_operands(x, wq, scale)
    acc = torch.matmul(x.float(), wq.float())
    return (acc * scale[None, :]).to(x.dtype)


def int8_matmul_cuda(x: torch.Tensor, wq: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: same contract as ``int8_matmul_reference`` for CUDA
    tensors; x any row stride with unit column stride, wq and scale
    contiguous. Any m, k, n (ragged edges masked in the kernel)."""
    _check_operands(x, wq, scale)
    if x.device.type != "cuda" or wq.device != x.device or scale.device != x.device:
        raise ValueError("int8_matmul_cuda needs CUDA tensors on one card")
    if x.stride(1) != 1:
        x = x.contiguous()
    wq, scale = wq.contiguous(), scale.contiguous()
    m, k = x.shape
    n = wq.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.library()
    _build.check(lib.st_int8_matmul(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k, n,
        x.stride(0) if m > 1 else k, int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device)),
        "st_int8_matmul")
    int8_matmul_cuda.launches += 1
    return out


int8_matmul_cuda.launches = 0
