"""CER and WER scoring by edit distance (counterpart of the JAX package's
``ops/metrics.py``).

The Levenshtein loops run in the native library ``native/editdistance.cc``
(built with the host compiler at first use; a failed build raises).
``cer`` scores a whole corpus in one call of its batched entry point
``edit_distance_corpus_i32``. ``force_python=True`` takes the pure-Python
version of the same function instead, the plain reference the native one
is held to."""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .. import native


def _edit_distance_py(ref: Sequence[int], hyp: Sequence[int]) -> int:
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


def edit_distance(ref: Sequence[int], hyp: Sequence[int], *,
                  force_python: bool = False) -> int:
    """Levenshtein distance between two token-id sequences."""
    if force_python:
        return _edit_distance_py(list(ref), list(hyp))
    lib = native.library("editdistance")
    a = np.ascontiguousarray(ref, np.int32)
    b = np.ascontiguousarray(hyp, np.int32)
    native.count("edit_distance_i32")
    return int(lib.edit_distance_i32(a.ctypes.data_as(native.I32P), len(a),
                                     b.ctypes.data_as(native.I32P), len(b)))


def _flat(seqs) -> Tuple[np.ndarray, np.ndarray]:
    """Sequences as one int32 buffer and int64 offsets (len + 1)."""
    off = np.zeros(len(seqs) + 1, np.int64)
    off[1:] = np.cumsum([len(s) for s in seqs])
    buf = np.zeros(max(int(off[-1]), 1), np.int32)
    for s, o in zip(seqs, off[:-1]):
        if len(s):
            buf[int(o):int(o) + len(s)] = np.asarray(s, np.int32)
    return buf, off


def _corpus_errors(refs, hyps, force_python: bool) -> Tuple[int, int]:
    if force_python:
        return (sum(_edit_distance_py(list(r), list(h)) for r, h in zip(refs, hyps)),
                sum(len(r) for r in refs))
    lib = native.library("editdistance")
    (rbuf, roff), (hbuf, hoff) = _flat(refs), _flat(hyps)
    out = np.zeros(2, np.int64)
    native.count("edit_distance_corpus_i32")
    lib.edit_distance_corpus_i32(
        rbuf.ctypes.data_as(native.I32P), roff.ctypes.data_as(native.I64P),
        hbuf.ctypes.data_as(native.I32P), hoff.ctypes.data_as(native.I64P),
        ctypes.c_int64(len(refs)), out.ctypes.data_as(native.I64P))
    return int(out[0]), int(out[1])


def cer(refs: List[Sequence[int]], hyps: List[Sequence[int]], *,
        force_python: bool = False) -> Dict[str, float]:
    """Character error rate over a corpus of token-id sequences.

    Returns dict with ``cer`` (%), total ``errors`` and ``ref_tokens``.
    """
    if len(refs) != len(hyps):
        raise ValueError(f"refs ({len(refs)}) and hyps ({len(hyps)}) differ in count")
    errors, total = _corpus_errors(refs, hyps, force_python) if refs else (0, 0)
    return {
        "cer": 100.0 * errors / max(total, 1),
        "errors": float(errors),
        "ref_tokens": float(total),
    }


def wer(ref_words: List[Sequence[str]], hyp_words: List[Sequence[str]], *,
        force_python: bool = False) -> Dict[str, float]:
    """Word error rate: each pair's words are numbered, then scored as
    ``cer`` scores tokens. Returns ``wer`` (%), ``errors`` and ``ref_tokens``."""
    refs_ids, hyps_ids = [], []
    for r, h in zip(ref_words, hyp_words):
        vocab: Dict[str, int] = {}
        ids = lambda ws: [vocab.setdefault(w, len(vocab)) for w in ws]
        refs_ids.append(ids(list(r)))
        hyps_ids.append(ids(list(h)))
    out = cer(refs_ids, hyps_ids, force_python=force_python)
    out["wer"] = out.pop("cer")
    return out
