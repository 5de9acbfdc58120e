"""Bytes and operations of the decode step's cross-attention
(``kernels/cross_attention.py``): one decoder layer at one step, the K
beams of each utterance against its cross K/V over its valid encoder
frames T_b.

Bytes: each utterance's valid frames of K and V, read once for all its
beams, in the compute dtype; the queries in and the output out; the
lengths (int32). Operations: 4 K H T_b D an utterance (QK and PV),
against the bf16 peak."""

from __future__ import annotations

from typing import Iterable

from ..peaks import BF16_FLOP_PER_S, bound_s
from .model import subsampled


def call_counts(valid: Iterable[int], beams: int, h: int, d: int, esz: int = 2):
    """(bytes, operations) of one call over utterances of ``valid``
    encoder frames."""
    valid = list(valid)
    rows = len(valid) * beams
    nbytes = sum(2 * t * h * d * esz for t in valid) + 2 * rows * h * d * esz + 4 * len(valid)
    return nbytes, float(sum(4 * beams * h * t * d for t in valid))


def call_bound_s(valid: Iterable[int], beams: int, h: int, d: int, esz: int = 2) -> float:
    return bound_s(*call_counts(valid, beams, h, d, esz), BF16_FLOP_PER_S)


def serve_bound_s(m: dict, frames: Iterable[int], beam: int, steps: int) -> float:
    """Least time of a served call's cross-attention kernels: every decoder
    layer at every step run, over the utterances' fbank ``frames``."""
    h = m["num_heads"]
    esz = 4 if m["dtype"] == "float32" else 2
    valid = [subsampled(f) for f in frames]
    return m["num_decoder_layers"] * steps * call_bound_s(valid, beam, h, m["d_model"] // h, esz)
