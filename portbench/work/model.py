"""Model FLOPs of the Speech-Transformer: 2 m n k for every product of
the forward pass, on valid lengths (attention counts QK^T and PV over the
kept key positions). A train step counts three forwards (forward and
backward; no recompute). A served call counts the encoder, the
cross-attention cache and every decode step run for every beam."""

from __future__ import annotations

from typing import Iterable


def subsampled(n: int) -> int:
    for _ in range(2):
        n = (n - 3) // 2 + 1
    return max(n, 0)


def encoder_flops(m: dict, frames: int) -> float:
    d, ff, c = m["d_model"], m["d_ff"], m["subsample_channels"]
    f1 = (m["input_dim"] - 3) // 2 + 1
    f2 = (f1 - 3) // 2 + 1
    t1 = max((frames - 3) // 2 + 1, 0)
    t2 = subsampled(frames)
    total = 2.0 * t1 * f1 * c * 9 + 2.0 * t2 * f2 * c * c * 9 + 2.0 * t2 * f2 * c * d
    layer = 2.0 * t2 * d * 3 * d + 4.0 * t2 * t2 * d + 2.0 * t2 * d * d + 4.0 * t2 * d * ff
    return total + m["num_encoder_layers"] * layer


def decoder_flops(m: dict, u: int, t2: int) -> float:
    """Teacher-forced decoder over ``u`` targets against ``t2`` frames."""
    d, ff, v = m["d_model"], m["d_ff"], m["vocab_size"]
    self_attn = 2.0 * u * d * 3 * d + 4.0 * d * u * (u + 1) / 2 + 2.0 * u * d * d
    cross = 2.0 * u * d * d + 2.0 * t2 * d * 2 * d + 4.0 * d * u * t2 + 2.0 * u * d * d
    layer = self_attn + cross + 4.0 * u * d * ff
    return m["num_decoder_layers"] * layer + 2.0 * u * d * v


def train_step_flops(m: dict, frames: Iterable[int], target_lens: Iterable[int]) -> float:
    return 3.0 * sum(encoder_flops(m, f) + decoder_flops(m, u, subsampled(f))
                     for f, u in zip(frames, target_lens))


def decode_row_flops(m: dict, index: int, t2: int) -> float:
    """One beam's decode step at position ``index``."""
    d, ff, v = m["d_model"], m["d_ff"], m["vocab_size"]
    layer = (2.0 * d * 3 * d + 4.0 * d * (index + 1) + 2.0 * d * d
             + 4.0 * d * d + 4.0 * d * t2 + 4.0 * d * ff)
    return m["num_decoder_layers"] * layer + 2.0 * d * v


def serve_call_flops(m: dict, frames: Iterable[int], beam: int, steps: int) -> float:
    total = 0.0
    for f in frames:
        t2 = subsampled(f)
        total += encoder_flops(m, f) + m["num_decoder_layers"] * 2.0 * t2 * m["d_model"] * 2 * m["d_model"]
        total += beam * sum(decode_row_flops(m, i, t2) for i in range(steps))
    return total
