"""Bytes and operations of lineage attention: one decode step's
self-attention of ``rows`` = batch x beams query rows against a cache of
``index + 1`` positions read through the lineage table.

Bytes: the K and V rows read (``distinct`` of them: lanes that share an
ancestor share its row), the query in and the output out, and the lineage
columns read (int32). Operations: rows x heads x positions x (4 D + 5)
(QK, PV and the softmax), against the float32 peak, as the kernel
computes in float32."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..peaks import F32_FLOP_PER_S, bound_s


def counts(rows: int, index: int, h: int, d: int, esz: int = 2,
           distinct: Optional[int] = None):
    """(bytes, operations) of one call; ``distinct`` defaults to every lane
    of every position."""
    positions = index + 1
    if distinct is None:
        distinct = rows * positions
    nbytes = 2 * distinct * h * d * esz + 2 * rows * h * d * esz + rows * positions * 4
    return nbytes, float(rows * h * positions * (4 * d + 5))


def bound_ms(rows, index, h, d, esz=2, distinct=None) -> float:
    return bound_s(*counts(rows, index, h, d, esz, distinct), F32_FLOP_PER_S) * 1e3


def distinct_rows(tokens: np.ndarray, steps: int) -> List[int]:
    """K/V rows that the call's kernel reads at each step 0 .. steps - 1,
    from the served hypotheses ``tokens`` [B, K, >= steps].

    At step t a lane reads its own new row at position t and, at each
    position p < t, the row of its ancestor, which lanes whose first p
    tokens agree share. The served hypotheses are the lanes alive at the
    last step (random weights never end one), and each one's first t
    tokens were a lane at step t. Lanes that a later step dropped are not
    seen, so at each step this counts the K own rows and the distinct
    prefixes among the served hypotheses: a floor of the rows read."""
    b, k = tokens.shape[:2]
    shared = [sum(len({tokens[u, r, :p].tobytes() for r in range(k)}) for u in range(b))
              for p in range(steps)]
    return [b * k + sum(shared[:t]) for t in range(steps)]


def decode_call_bound_s(m: dict, batch: int, beam: int, steps: int,
                        tokens: np.ndarray) -> float:
    """Least time of a served call's lineage kernels: every decoder layer
    at every step run, reading the rows of ``distinct_rows``."""
    h = m["num_heads"]
    d = m["d_model"] // h
    one = sum(bound_s(*counts(batch * beam, i, h, d, distinct=n), F32_FLOP_PER_S)
              for i, n in enumerate(distinct_rows(tokens, steps)))
    return m["num_decoder_layers"] * one
