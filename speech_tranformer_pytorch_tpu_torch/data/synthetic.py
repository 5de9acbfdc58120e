"""Seeded synthetic utterances: int16 PCM tone sequences with noise.

Each utterance is a run of 120 ms pure tones at log-spaced frequencies plus
white noise — speech-like enough to exercise the fbank and the model at
real lengths, with no corpus."""

from __future__ import annotations

from typing import Tuple

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
