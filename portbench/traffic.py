"""The one traffic generator: every mix under ``mixes/`` is data for it.

A mix fixes the batches it serves or trains on: ``batches_per_bucket``
batches of ``batch`` utterances in each of the port's length buckets it
lists (``data.bucket_boundaries``: a bucket holds the utterances whose
Kaldi frame count lies above the previous boundary and at or below its
own), the token rate and, for serving, the decode settings. Within a
bucket the frame counts are uniform, from the mix's own ``lengths_seed``
(the first bucket starts at ``min_s``), so every ``--seed`` gets the same
set of sizes. The length mix is a sweep of the buckets, not a corpus's
distribution: no length histogram of AISHELL-1 or LibriSpeech is at hand
to draw from. Each batch is padded to its bucket's boundary, as the port
pads its batches. ``--seed`` orders the batches and makes the audio and
the tokens: so two seeds run the same work in another order.

The audio is synthetic int16 PCM: a seeded voiced signal (a wandering
fundamental with five harmonics under a syllable-rate envelope, plus
noise), from which each utterance takes a window at a seeded offset and
gain, so no two rows are alike.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

PAD, SOS, EOS, FIRST_TOKEN = 0, 1, 2, 4


@dataclasses.dataclass
class HostBatch:
    """One padded batch in host memory."""
    index: int                 # position in the mix's fixed plan
    bucket: int                # the bucket's frame boundary
    audio: np.ndarray          # [B, S] int16
    sample_lens: np.ndarray    # [B] int32
    targets_in: Optional[np.ndarray] = None    # [B, U] int32 (training)
    targets_out: Optional[np.ndarray] = None
    target_lens: Optional[np.ndarray] = None
    max_len: int = 0           # decode steps allowed (serving)
    seconds: float = 0.0       # audio seconds of the valid samples

    def shape_key(self) -> Tuple:
        width = None if self.targets_in is None else self.targets_in.shape[1]
        return (self.audio.shape, width, self.max_len)


def frame_geometry(features: dict) -> Tuple[int, int]:
    sr = features["sample_rate"]
    return (int(sr * features["frame_length_ms"] / 1000.0),
            int(sr * features["frame_shift_ms"] / 1000.0))


def frames_of(samples, features: dict):
    flen, hop = frame_geometry(features)
    return np.where(np.asarray(samples) < flen, 0, 1 + (np.asarray(samples) - flen) // hop)


def samples_of(frames: int, features: dict) -> int:
    flen, hop = frame_geometry(features)
    return flen + (frames - 1) * hop


def subsampled(n: int) -> int:
    for _ in range(2):
        n = (n - 3) // 2 + 1
    return n


def draw_batches(mix: dict, boundaries: Sequence[int], features: dict
                 ) -> List[Tuple[int, np.ndarray]]:
    """(bucket index, sample counts [batch]) of every batch of the mix, in
    bucket order: frame counts uniform over each listed bucket's range,
    from ``lengths_seed``, cut to the bucket's padded width as the port
    cuts its batches."""
    spec = mix["lengths"]
    flen, hop = frame_geometry(features)
    first = int(frames_of(int(round(spec["min_s"] * features["sample_rate"])), features))
    rng = np.random.default_rng(mix["lengths_seed"])
    out = []
    for bnd in spec["buckets"]:
        i = list(boundaries).index(bnd)
        lo = max(first, boundaries[i - 1] + 1 if i else 1)
        for _ in range(spec["batches_per_bucket"]):
            frames = rng.integers(lo, bnd + 1, mix["batch"])
            samples = flen + (frames - 1) * hop + rng.integers(0, hop, mix["batch"])
            out.append((i, np.minimum(samples, samples_of(bnd, features))))
    return out


def voiced_signal(rng: np.random.Generator, seconds: float, sr: int) -> np.ndarray:
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 120.0 + 60.0 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 2 * np.pi)) \
        + 20.0 * np.sin(2 * np.pi * 1.7 * t + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(h * phase + rng.uniform(0, 2 * np.pi)) / h for h in range(1, 6))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 4.0 * t + rng.uniform(0, 2 * np.pi))
    return (x * env + 0.1 * rng.standard_normal(n)).astype(np.float32)


def build_pool(mix: dict, cfg: dict, seed: int, *, train: bool) -> List[HostBatch]:
    """The mix's batches, in the order ``seed`` gives them."""
    f, data, model = cfg["features"], cfg["data"], cfg["model"]
    sr = f["sample_rate"]
    batches = draw_batches(mix, data["bucket_boundaries"], f)
    rng = np.random.default_rng([int(seed), 0x5eed])
    order = rng.permutation(len(batches))
    base = voiced_signal(rng, mix.get("signal_seconds", 60.0), sr)
    base = np.concatenate([base, base])
    half = len(base) // 2
    target_len = min(data["max_target_len"], model["max_target_positions"])
    pool = []
    for pos in order:
        bidx, n = batches[pos]
        bnd = data["bucket_boundaries"][bidx]
        audio = np.zeros((len(n), samples_of(bnd, f)), np.int16)
        for r, k in enumerate(n):
            off = int(rng.integers(0, half))
            gain = float(rng.uniform(2000.0, 9000.0))
            audio[r, :k] = np.clip(base[off:off + k] * gain, -32768, 32767).astype(np.int16)
        hb = HostBatch(index=int(pos), bucket=int(bnd), audio=audio,
                       sample_lens=n.astype(np.int32), seconds=float(n.sum()) / sr)
        if train:
            ntok = np.clip(np.round(mix["tokens_per_s"] * n / sr).astype(np.int64), 1,
                           target_len - 1)
            need = max(2, int(ntok.max()) + 1)
            width = target_len if target_len <= 16 else min(target_len, -(-need // 16) * 16)
            tin = np.full((len(n), width), PAD, np.int32)
            tout = np.full((len(n), width), PAD, np.int32)
            for r, k in enumerate(ntok):
                toks = rng.integers(FIRST_TOKEN, model["vocab_size"], int(k))
                tin[r, 0] = SOS
                tin[r, 1:1 + k] = toks
                tout[r, :k] = toks
                tout[r, k] = EOS
            hb.targets_in, hb.targets_out = tin, tout
            hb.target_lens = (ntok + 1).astype(np.int32)
        else:
            d = mix["decode"]
            enc = subsampled(bnd)
            hb.max_len = max(4, min(d["max_decode_len"], int(d["max_len_ratio"] * enc)))
        pool.append(hb)
    return pool
