"""Tracing and profiling (counterpart of the JAX package's
``utils/profiling.py``): a ``torch.profiler`` trace written as a Chrome
trace, named scopes that show on its timeline, a host sync that waits for
the card, and a step timer for throughput (audio-s/s, tokens/s)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace") -> Iterator[profile]:
    """Profile the block on the CPU and, where there is a card, on CUDA;
    writes ``<log_dir>/<name>.json`` (a Chrome trace, for chrome://tracing
    or Perfetto) when the block ends. Yields the profiler, whose
    ``events()`` and ``key_averages()`` the caller may read."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


def named_scope(name: str):
    """Annotation scope that shows up on the trace's timeline."""
    return record_function(name)


def sync(x: torch.Tensor) -> float:
    """Wait for the card (when ``x`` is on one) and pull ``x``'s first
    element to the host; returns it."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return float(x.detach().reshape(-1)[0])


class StepTimer:
    """Throughput accounting (audio-s/s, tokens/s) with correct syncing."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._audio = 0.0
        self._tokens = 0.0
        self._steps = 0

    def record(self, *, audio_seconds: float = 0.0, tokens: float = 0.0):
        self._audio += audio_seconds
        self._tokens += tokens
        self._steps += 1

    def rates(self, sync_on=None) -> Dict[str, float]:
        if sync_on is not None:
            sync(sync_on)
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "steps_per_s": self._steps / dt,
            "audio_sps": self._audio / dt,
            "tokens_per_s": self._tokens / dt,
            "wall_s": dt,
        }
