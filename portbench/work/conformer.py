"""Model FLOPs of the Conformer encoder (``model.encoder`` 'conformer'),
and the bytes and operations of its relative-position attention kernel
(``kernels/relpos_attention.py``).

FLOPs count 2 m n k for every product of the forward pass on each
utterance's valid frames t (as ``work/model.py`` counts the Transformer):
the subsampling, and per block the two feed-forwards, the q/k/v and output
projections, the position projection of the 2t - 1 rows, the three
attention products (content and position scores, P·V: 6 t² d), the
pointwise convolutions (d → 2d, d → d) and the depthwise one (2 t d k).

The kernel, per utterance and layer: bytes are q, k, v and the output of
the t valid frames and the 2t - 1 position rows, each once, in bf16;
operations 6 H t² D (the two score products and P·V), against the bf16
peak.
"""

from __future__ import annotations

from typing import Iterable

from ..peaks import BF16_FLOP_PER_S, bound_s
from .model import decode_row_flops, subsampled


def encoder_flops(m: dict, frames: int) -> float:
    d, ff, c, k = m["d_model"], m["d_ff"], m["subsample_channels"], m["conv_kernel"]
    f1 = (m["input_dim"] - 3) // 2 + 1
    f2 = (f1 - 3) // 2 + 1
    t1 = max((frames - 3) // 2 + 1, 0)
    t = subsampled(frames)
    total = 2.0 * t1 * f1 * c * 9 + 2.0 * t * f2 * c * c * 9 + 2.0 * t * f2 * c * d
    ffns = 2 * 4.0 * t * d * ff
    attn = 2.0 * t * d * 3 * d + 2.0 * t * d * d + 2.0 * max(2 * t - 1, 0) * d * d
    attn += 6.0 * t * t * d
    conv = 2.0 * t * d * 2 * d + 2.0 * t * d * k + 2.0 * t * d * d
    return total + m["num_encoder_layers"] * (ffns + attn + conv)


def serve_call_flops(m: dict, frames: Iterable[int], beam: int, steps: int) -> float:
    """A served call: the Conformer encoder, the cross-attention cache and
    every decode step run for every beam (``work/model.py``'s decoder)."""
    total = 0.0
    for f in frames:
        t = subsampled(f)
        total += encoder_flops(m, f) + m["num_decoder_layers"] * 2.0 * t * m["d_model"] * 2 * m["d_model"]
        total += beam * sum(decode_row_flops(m, i, t) for i in range(steps))
    return total


def relpos_counts(valid: Iterable[int], h: int, d: int, esz: int = 2):
    """(bytes, operations) of one kernel call over utterances of ``valid``
    encoder frames."""
    valid = list(valid)
    nbytes = sum((4 * t + max(2 * t - 1, 0)) * h * d * esz for t in valid)
    return float(nbytes), float(sum(6 * h * t * t * d for t in valid))


def relpos_bound_s(valid: Iterable[int], h: int, d: int) -> float:
    return bound_s(*relpos_counts(valid, h, d), BF16_FLOP_PER_S)


def serve_relpos_bound_s(m: dict, frames: Iterable[int]) -> float:
    """Least time of a served call's relative-position attention kernels:
    one call an encoder layer over the utterances' fbank ``frames``."""
    h = m["num_heads"]
    valid = [subsampled(f) for f in frames]
    return m["num_encoder_layers"] * relpos_bound_s(valid, h, m["d_model"] // h)
