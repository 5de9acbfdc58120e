"""CER scoring by edit distance, in pure Python (the JAX package's
``ops/metrics.py`` counterpart without its optional native library)."""

from __future__ import annotations

from typing import Dict, List, Sequence


def edit_distance(ref: Sequence[int], hyp: Sequence[int]) -> int:
    """Levenshtein distance between two token-id sequences."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        ri = ref[i - 1]
        for j in range(1, m + 1):
            cost = 0 if ri == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


def cer(refs: List[Sequence[int]], hyps: List[Sequence[int]]) -> Dict[str, float]:
    """Character error rate over a corpus of token-id sequences.

    Returns dict with ``cer`` (%), total ``errors`` and ``ref_tokens``.
    """
    if len(refs) != len(hyps):
        raise ValueError(f"refs ({len(refs)}) and hyps ({len(hyps)}) differ in count")
    errors = sum(edit_distance(list(r), list(h)) for r, h in zip(refs, hyps))
    total = sum(len(r) for r in refs)
    return {
        "cer": 100.0 * errors / max(total, 1),
        "errors": float(errors),
        "ref_tokens": float(total),
    }
