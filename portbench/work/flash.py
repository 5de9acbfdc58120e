"""Bytes and operations of the flash-attention kernels (forward, dK/dV,
dQ) for one attention call, and the calls of a train step.

Each input is read once and each output written once: the forward reads
Q, K, V and writes O and the log-sum-exp; dK/dV reads Q, K, V, dO, the
log-sum-exp and D = rowsum(dO * O) and writes dK, dV; dQ reads Q, K, V,
dO and the two statistics and writes dQ. Operations: 4 D (forward), 8 D
(dK/dV) and 6 D (dQ) for every kept (query, key) pair of every head
(every query row; keys below the row's length, and on or below the
diagonal when causal)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

from ..peaks import BF16_FLOP_PER_S, bound_s
from .model import subsampled


def pairs(tq: int, kv_lens: Sequence[int], causal: bool) -> int:
    if not causal:
        return tq * sum(int(n) for n in kv_lens)
    return sum(sum(min(t + 1, int(n)) for t in range(tq)) for n in kv_lens)


def counts(b: int, h: int, tq: int, tk: int, d: int, kv_lens: Sequence[int],
           causal: bool, esz: int = 2) -> Dict[str, Tuple[float, float]]:
    """{kernel: (bytes, operations)} of one call."""
    io_q, io_k, stat = b * h * tq * d * esz, b * h * tk * d * esz, b * h * tq * 4
    p = h * pairs(tq, kv_lens, causal)
    return {"fwd": (2 * io_q + 2 * io_k + stat, 4.0 * d * p),
            "dkv": (2 * io_q + 4 * io_k + 2 * stat, 8.0 * d * p),
            "dq": (3 * io_q + 2 * io_k + 2 * stat, 6.0 * d * p)}


def bound_ms(b, h, tq, tk, d, kv_lens, causal, kernel: str = "fwd", esz: int = 2) -> float:
    nbytes, flops = counts(b, h, tq, tk, d, kv_lens, causal, esz)[kernel]
    return bound_s(nbytes, flops, BF16_FLOP_PER_S) * 1e3


def train_step_calls(m: dict, frames_pad: int, frames: Iterable[int], u_pad: int,
                     target_lens: Iterable[int]) -> List[tuple]:
    """(b, h, tq, tk, d, kv_lens, causal) of every attention call of a
    teacher-forced step: encoder self-attention, decoder causal
    self-attention and cross-attention, layer by layer."""
    t_pad = subsampled(frames_pad)
    t_lens = [subsampled(f) for f in frames]
    u = list(target_lens)
    b, h = len(t_lens), m["num_heads"]
    d = m["d_model"] // h
    enc = (b, h, t_pad, t_pad, d, t_lens, False)
    dec = [(b, h, u_pad, u_pad, d, u, True), (b, h, u_pad, t_pad, d, t_lens, False)]
    return [enc] * m["num_encoder_layers"] + dec * m["num_decoder_layers"]


def train_step_bound_s(m: dict, frames_pad: int, frames, u_pad: int, target_lens) -> float:
    """Least time of a step's forward, dK/dV and dQ kernels together."""
    total = 0.0
    for call in train_step_calls(m, frames_pad, frames, u_pad, target_lens):
        for nbytes, flops in counts(*call).values():
            total += bound_s(nbytes, flops, BF16_FLOP_PER_S)
    return total
