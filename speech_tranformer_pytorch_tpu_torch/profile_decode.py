"""Where the time of one served batch goes, on a CUDA card.

    python -m speech_tranformer_pytorch_tpu_torch.profile_decode

Runs the smoke main path (``smoke_batch``: ``base`` preset, seeded random
weights, 8 int16 utterances of 4-6 s, beam 5, max_len 100) once to warm
up, once timed, then once under ``torch.profiler``. Prints one JSON line:
the wall time, the device's busy time (union of kernel intervals) and idle
share, kernel launches per decode step, and the kernels that take the most
device time. ``chip_smoke.py`` serves the same batch through
``smoke_batch``, so the trace describes the path it measures.
"""

from __future__ import annotations

import collections
import json
import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from .config import ExperimentConfig, get_config
from .data.synthetic import make_utterances
from .device import DeviceLike
from .models import SpeechTransformer
from .recognize import Recognizer

DECODE = dict(beam_size=5, max_len=100, alpha=1.0)


class SmokeBatch(NamedTuple):
    cfg: ExperimentConfig
    params: Dict[str, torch.Tensor]   # float32 state_dict, on the CPU
    recognizer: Recognizer
    audio: np.ndarray                 # [8, S] int16
    lens: np.ndarray                  # [8] valid sample counts


def smoke_audio():
    """8 seeded int16 utterances of 4-6 s: (audio [8, S], lens [8])."""
    return make_utterances(8, min_seconds=4.0, max_seconds=6.0, seed=0)


def smoke_batch(device: DeviceLike = None) -> SmokeBatch:
    """The main path's batch: the ``base`` preset with seeded random
    weights (generator seed 0) and ``smoke_audio``, served by a
    ``Recognizer`` on ``device``; decode it with ``DECODE``."""
    cfg = get_config("base")
    params = SpeechTransformer(cfg.model).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    audio, lens = smoke_audio()
    return SmokeBatch(cfg, params, Recognizer(cfg, params, device=device),
                      audio, lens)


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = smoke_batch()
    rec = batch.recognizer
    rec.decode_batch(batch.audio, batch.lens, **DECODE)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    rec.decode_batch(batch.audio, batch.lens, **DECODE)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec.decode_batch(batch.audio, batch.lens, **DECODE)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    steps = rec.last_steps
    print(json.dumps({"profile": {
        "device": torch.cuda.get_device_name(0),
        "wall_s": wall_plain, "wall_s_profiled": wall_prof, "decode_steps": steps,
        "device_events": len(kernels),
        "launches_per_step": len(kernels) / max(steps, 1),
        "device_busy_s": busy / 1e6,
        "device_idle_share": 1.0 - busy / 1e6 / wall_prof,
        "top_kernels": [{"name": n[:90], "calls": c, "total_ms": t / 1e3}
                        for n, (c, t) in top]}}), flush=True)


if __name__ == "__main__":
    main()
