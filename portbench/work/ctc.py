"""Bytes and operations of the CTC prefix scorer (``kernels/ctc_prefix.py``):
one beam step scores the P pre-beam candidates of each of the B x K
hypotheses, each over the frames s = max(n, 1) .. T_b - 1 of its
utterance (n the step, T_b the utterance's valid frames).

Bytes, a floor over those frames: each candidate reads its row of
log-probs and writes its two state rows; each hypothesis's state (two
rows) and each utterance's blank row are read once; 4 bytes an entry.
Operations: three log-add-exps a candidate-frame (rn, rb and psi), each
counted as 6 float32 operations (max, subtract, abs, exp, log1p, add),
and the 3 adds of the log-probs: 21, against the float32 peak."""

from __future__ import annotations

from typing import Iterable

from ..peaks import F32_FLOP_PER_S, bound_s
from .model import subsampled

OPS_PER_CANDIDATE_FRAME = 21


def pre_beam(beam: int) -> int:
    """Candidates a hypothesis scores (ESPnet's ``pre_beam_ratio`` 1.5)."""
    return int(1.5 * beam)


def step_counts(valid: Iterable[int], beam: int, n: int):
    """(bytes, operations) of the step at hypothesis length ``n`` over
    utterances of ``valid`` encoder frames."""
    p = pre_beam(beam)
    nbytes = ops = 0.0
    for tb in valid:
        f = max(tb - max(n, 1), 0)
        nbytes += 4.0 * f * (beam * p * 3 + beam * 2 + 1)
        ops += float(OPS_PER_CANDIDATE_FRAME * beam * p * f)
    return nbytes, ops


def call_bound_s(frames: Iterable[int], beam: int, steps: int) -> float:
    """Least time of a served call's scorer: every step run, over the
    utterances' fbank ``frames``."""
    valid = [subsampled(f) for f in frames]
    return sum(bound_s(*step_counts(valid, beam, n), F32_FLOP_PER_S) for n in range(steps))
