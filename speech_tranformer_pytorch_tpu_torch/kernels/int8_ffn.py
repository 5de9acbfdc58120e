"""Fused int8-weight feed-forward of the decode step:
``y = relu((x @ w1q) * s1 + b1) @ w2q * s2 + b2`` in one launch.

Replaces the TPU kernel ``_kernel`` / ``int8_ffn``
(speech_tranformer_pytorch_tpu/kernels/int8_ffn.py:50, :73). On Hopper it
runs the feed-forward block of every serving decoder layer at every decode
step. The kernel is ``csrc/int8_ffn.cu``. What bounds it on an H100 is the
bytes (both int8 weights read once); the bf16 kernel sits above that,
latency-bound. Its design: both products transposed on register-A wgmma
(weight columns are wgmma's M, the few activation rows its N), the int8
slabs converted in registers, the hidden kept in shared memory as the
second product's operand, and the sum over ff reduce-scattered within a
thread-block cluster of up to 16 blocks that owns one or two 64-column
tiles of y (st.async into each owner's shared memory, summed in rank
order): one launch, no scratch, no atomics, bit-identical run to run.
``plan`` chooses the cluster's shape from the shapes alone. The f32 path
keeps its FMA kernel with per-block partials in a device scratch.

Math, shared by the kernel and its plain version, at the activation's
precision (bf16 or f32 operands, f32 accumulation, f32 scales and biases
on the accumulators): the hidden layer is rounded to the operand dtype
before the second product, and the result comes back in x's dtype.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _build
from .int8_matmul import _bf16_rows

# bf16 kernel (csrc/int8_ffn.cu, int8_ffn_bf16_kernel)
BLOCK_COLS = 64      # columns of y a tile (kCols): wgmma's M
MAX_COL_TILES_ROWS = 40   # two tiles of y a cluster only up to this many rows
MAX_ROWS = 64        # rows of x a cluster: wgmma's N, a multiple of 8
HIDDEN_TILES = (1, 2)   # 64-column hidden tiles a rank and slice
MAX_RANKS = 16       # blocks a cluster (kMaxRanks; past 8 non-portable)
# f32 kernel (int8_ffn_f32_kernel)
BLOCK_M = 64         # rows of x per block (kBM)
BLOCK_FF = 128       # hidden columns per block (kBF)
BLOCK_N = 64         # output columns per reduced chunk (kBN)


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


def plan(m: int, k: int, ff: int, n: int) -> Tuple[int, int, int, int]:
    """(rows, hidden_tiles, ranks, col_tiles) of the bf16 kernel for x
    [m, k] through ff hidden columns to n outputs: ``rows`` of x a cluster
    (m rounded up to a multiple of 8, at most ``MAX_ROWS``), and a cluster
    of ``ranks`` blocks for each 64 * ``col_tiles`` columns of y, each rank
    taking 64 * ``hidden_tiles`` hidden columns a slice. One hidden tile a
    rank while one cluster covers ff so, else two; past ``MAX_RANKS`` * 128
    hidden columns each rank takes several slices, and the ranks are as
    few as cover ff in that many slices. Two tiles of y a cluster (up to
    ``MAX_COL_TILES_ROWS`` rows and at least 8 tiles of y) halve how often
    w1 and x are read again. ``k`` does not change the plan."""
    rows = min(-(-max(m, 1) // 8) * 8, MAX_ROWS)
    tiles = HIDDEN_TILES[0] if ff <= 64 * HIDDEN_TILES[0] * MAX_RANKS else HIDDEN_TILES[-1]
    slices = -(-ff // (64 * tiles * MAX_RANKS))
    col_tiles = 2 if rows <= MAX_COL_TILES_ROWS and n >= 8 * BLOCK_COLS else 1
    return rows, tiles, -(-ff // (64 * tiles * slices)), col_tiles


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
    tensors; x any row stride with unit column stride (bf16 rows off the
    16-byte grid are copied, ``int8_matmul._bf16_rows``), the rest
    contiguous. Any m, k, ff, n (ragged edges masked in the kernel)."""
    _check_operands(x, w1q, s1, b1, w2q, s2, b2)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (w1q, s1, b1, w2q, s2, b2)):
        raise ValueError("int8_ffn_cuda needs CUDA tensors on one card")
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        x = _bf16_rows(x)
    elif x.stride(1) != 1:
        x = x.contiguous()
    w1q, s1, b1, w2q, s2, b2 = (t.contiguous() for t in (w1q, s1, b1, w2q, s2, b2))
    m, k = x.shape[0], w1q.shape[0]
    ff, n = w2q.shape
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    partial = counters = None   # the bf16 kernel sums within a cluster
    rows, tiles, ranks, col_tiles = plan(m, k, ff, n)
    if not bf16:
        partial = torch.empty((max(-(-ff // BLOCK_FF), 1), m, n), dtype=torch.float32,
                              device=dev)
        counters = _block_counters(dev, -(-m // BLOCK_M) * -(-n // BLOCK_N))
    lib = _build.library()
    _build.check(lib.st_int8_ffn(
        x.data_ptr(), w1q.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2q.data_ptr(),
        s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(), m, k, ff, n,
        x.stride(0) if m > 1 else x.shape[1], rows, tiles, col_tiles, ranks, int(bf16),
        _build.stream_ptr(dev)), "st_int8_ffn")
    int8_ffn_cuda.launches += 1
    return out


int8_ffn_cuda.launches = 0
