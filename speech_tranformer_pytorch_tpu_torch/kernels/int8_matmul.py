"""Int8-weight matmul of the decode step: ``y = (x @ wq) * scale``.

Replaces the TPU kernel ``_kernel`` / ``int8_matmul``
(speech_tranformer_pytorch_tpu/kernels/int8_matmul.py:52, :61). On Hopper
it runs every int8 dense layer of the serving decoder: the four attention
projections of each decode step and the cross K/V projections of
``init_cache``. The kernel is ``csrc/int8_matmul.cu``; its header says
what bounds it on an H100 (bytes: the int8 weight read once) and how the
int8 tile is converted after the load, so the weight stream stays int8.
``plan`` chooses the bf16 kernel's tiling (rows of x a block, the split
of k over blocks) from the shape alone.

Math, shared by the kernel and its plain version, at the activation's
precision: bf16 x gives bf16 operands (int8 values are exact in bf16),
f32 x gives f32 operands; f32 accumulation; the f32 per-column scale
multiplies the accumulator; the result comes back in x's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

BLOCK_COLS = 64      # columns of y a block (csrc/int8_matmul.cu kCols): wgmma's M
STAGE_K = 64         # k a ring stage (kStageK); a split of k is whole stages
MAX_ROWS = 64        # rows of x a block: wgmma's N, a multiple of 8
MAX_SPLITS = 4       # the splits of a tile are one cluster; past 4, rank 0's
                     # wait for the partials costs more than the split saves
TARGET_BLOCKS = 96   # blocks in flight the plan aims for (132 SMs)


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


def plan(m: int, k: int, n: int) -> Tuple[int, int]:
    """(rows, k_chunk) of the bf16 kernel for [m, k] x [k, n]: ``rows`` of x
    a block (m rounded up to a multiple of 8, at most ``MAX_ROWS``) and the
    split of k over blocks in chunks of ``k_chunk`` (whole stages), as few
    as bring the grid to ``TARGET_BLOCKS``, at most ``MAX_SPLITS``: each
    split adds a partial tile that its cluster reads back."""
    rows = min(-(-max(m, 1) // 8) * 8, MAX_ROWS)
    tiles = -(-n // BLOCK_COLS) * -(-m // rows)
    stages = max(-(-k // STAGE_K), 1)
    splits = min(max(-(-TARGET_BLOCKS // max(tiles, 1)), 1), stages, MAX_SPLITS)
    return rows, -(-stages // splits) * STAGE_K


def _bf16_rows(x: torch.Tensor) -> torch.Tensor:
    """x as the bf16 kernel copies it, 16 bytes at a time: rows 16-byte
    aligned, a row stride and k that are multiples of 8. Anything else gets
    an aligned copy, zero-padded to a multiple of 8 columns (x is small)."""
    m, k = x.shape
    if (x.stride(1) == 1 and k % 8 == 0 and x.data_ptr() % 16 == 0
            and (m == 1 or x.stride(0) % 8 == 0)):
        return x
    out = torch.zeros((m, -(-k // 8) * 8), dtype=x.dtype, device=x.device)
    out[:, :k] = x
    return out


def int8_matmul_cuda(x: torch.Tensor, wq: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: same contract as ``int8_matmul_reference`` for CUDA
    tensors; x any row stride with unit column stride (bf16 rows off the
    16-byte grid are copied, ``_bf16_rows``), wq and scale contiguous. Any
    m, k, n (ragged edges masked in the kernel)."""
    _check_operands(x, wq, scale)
    dev = x.device
    if dev.type != "cuda" or wq.device != dev or scale.device != dev:
        raise ValueError("int8_matmul_cuda needs CUDA tensors on one card")
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        x = _bf16_rows(x)
    elif x.stride(1) != 1:
        x = x.contiguous()
    wq, scale = wq.contiguous(), scale.contiguous()
    m, k = x.shape[0], wq.shape[0]
    n = wq.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    rows, k_chunk = plan(m, k, n)
    lib = _build.library()
    _build.check(lib.st_int8_matmul(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k, n,
        x.stride(0) if m > 1 else x.shape[1], rows, k_chunk, int(bf16),
        _build.stream_ptr(dev)), "st_int8_matmul")
    int8_matmul_cuda.launches += 1
    return out


int8_matmul_cuda.launches = 0
