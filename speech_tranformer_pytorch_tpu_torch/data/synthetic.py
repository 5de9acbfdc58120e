"""Seeded synthetic data.

``make_utterances``: int16 PCM runs of 120 ms pure tones at log-spaced
frequencies plus white noise — speech-like enough to exercise the fbank and
the model at real lengths, with no corpus. ``make_synthetic_dataset`` and
``batch_from_dataset``: the JAX package's overfit-anchor data, one tone per
transcript token."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def make_utterances(num: int, *, min_seconds: float, max_seconds: float,
                    sample_rate: int = 16000, seed: int = 0,
                    tone_ms: float = 120.0, noise: float = 0.01
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(audio int16 [num, S_max] zero-padded, sample_lens int32 [num])."""
    rng = np.random.default_rng(seed)
    tone_len = int(sample_rate * tone_ms / 1000.0)
    freqs = 200.0 * (2.0 ** (np.arange(28) / 6.0))
    lens = rng.integers(int(min_seconds * sample_rate),
                        int(max_seconds * sample_rate) + 1, size=num)
    audio = np.zeros((num, int(lens.max())), np.int16)
    t = np.arange(tone_len) / sample_rate
    for i, n in enumerate(lens):
        tones = rng.integers(0, len(freqs), size=-(-int(n) // tone_len))
        wave = np.concatenate([np.sin(2 * np.pi * freqs[f] * t) for f in tones])[:n]
        wave = 0.3 * wave + noise * rng.standard_normal(n)
        audio[i, :n] = np.clip(np.round(wave * 32767.0), -32768, 32767)
    return audio, lens.astype(np.int32)


# ---------------------------------------------------------------------------
# The overfit anchor's data: one tone per transcript token (the JAX package's
# data/synthetic.py), so a tiny model learns audio -> text in a few hundred
# steps.

PAD, SOS, EOS, UNK = 0, 1, 2, 3
NUM_SPECIALS = 4


@dataclasses.dataclass
class SyntheticDataset:
    waves: List[np.ndarray]           # float32 audio
    transcripts: List[List[int]]      # token ids (>= NUM_SPECIALS)
    vocab_size: int
    sample_rate: int


def make_synthetic_dataset(num_utterances: int = 10, *, vocab_size: int = 32,
                           min_tokens: int = 2, max_tokens: int = 6,
                           tone_ms: float = 120.0, sample_rate: int = 16000,
                           seed: int = 0, noise: float = 0.01) -> SyntheticDataset:
    """The JAX ``make_synthetic_dataset`` draw for draw: the same seed gives
    the same waves and transcripts."""
    rng = np.random.default_rng(seed)
    n_real = vocab_size - NUM_SPECIALS
    tone_len = int(sample_rate * tone_ms / 1000.0)
    freqs = 200.0 * (2.0 ** (np.arange(n_real) / 6.0))
    waves, transcripts = [], []
    for _ in range(num_utterances):
        n_tok = int(rng.integers(min_tokens, max_tokens + 1))
        toks = rng.integers(0, n_real, n_tok)
        t = np.arange(tone_len) / sample_rate
        segs = [np.sin(2 * np.pi * freqs[tk] * t) for tk in toks]
        wave = np.concatenate(segs) + noise * rng.standard_normal(tone_len * n_tok)
        waves.append(wave.astype(np.float32))
        transcripts.append([int(tk) + NUM_SPECIALS for tk in toks])
    return SyntheticDataset(waves, transcripts, vocab_size, sample_rate)


def pad_targets(transcripts: Sequence[Sequence[int]], width: int = 0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(targets_in = <sos>+y, targets_out = y+<eos>, lens incl. <eos>), int32,
    padded with <pad> to ``width`` (default: the longest target + 1)."""
    u = width or (max(len(t) for t in transcripts) + 1)
    n = len(transcripts)
    tgt_in = np.full((n, u), PAD, np.int32)
    tgt_out = np.full((n, u), PAD, np.int32)
    lens = np.zeros((n,), np.int32)
    for b, t in enumerate(transcripts):
        tgt_in[b, 0] = SOS
        tgt_in[b, 1:1 + len(t)] = t
        tgt_out[b, :len(t)] = t
        tgt_out[b, len(t)] = EOS
        lens[b] = len(t) + 1
    return tgt_in, tgt_out, lens


def batch_from_dataset(ds: SyntheticDataset, feature_cfg, *,
                       indices: Optional[Tuple[int, ...]] = None,
                       max_target_len: int = 0, device=None):
    """Pad the (sub)set into one ``train.Batch``, features extracted on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    from ..train import Batch
    from .features import extract_features

    idx = list(indices) if indices is not None else list(range(len(ds.waves)))
    waves = [ds.waves[i] for i in idx]
    audio = np.zeros((len(idx), max(len(w) for w in waves)), np.float32)
    slens = np.array([len(w) for w in waves], np.int32)
    for b, w in enumerate(waves):
        audio[b, :len(w)] = w
    tgt_in, tgt_out, tlens = pad_targets([ds.transcripts[i] for i in idx],
                                         max_target_len)
    feats, flens = extract_features(audio, slens, feature_cfg, device=device)
    return Batch(feats=feats, frame_lens=flens, targets_in=tgt_in,
                 targets_out=tgt_out, target_lens=tlens).to(feats.device)
