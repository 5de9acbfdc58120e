"""Where the time of one train step goes, on a CUDA card.

    python -m speech_tranformer_pytorch_tpu_torch.profile_train

Runs the smoke train path (``smoke_train_batch``: ``base`` preset at full
width and depth, seeded random weights, dropout 0.1, 64 int16 utterances
of 4-6 s with 10-30 random target tokens) for 3 warm-up steps and 10 timed
steps, then one step under ``torch.profiler``. Prints one JSON line: the
median step wall time, the device's busy time (union of kernel intervals)
and idle share in the profiled step, its device events, device time by
kernel group (the port's kernels, GEMMs, convolutions, norms, the rest)
and the kernels that take the most device time. ``chip_smoke.py`` trains
on the same batch through ``smoke_train_batch``, so the trace describes
the path it checks.
"""

from __future__ import annotations

import collections
import json
import statistics
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from .config import ExperimentConfig, get_config
from .data.pipeline import AudioBatch, make_audio_train_step
from .data.synthetic import make_utterances, pad_targets
from .device import DeviceLike, resolve_device
from .profile_decode import _busy_us
from .train import TrainState, create_train_state

WARMUP_STEPS, TIMED_STEPS = 3, 10


class SmokeTrainBatch(NamedTuple):
    cfg: ExperimentConfig
    state: TrainState
    batch: AudioBatch                 # on the state's device
    step: Callable                    # make_audio_train_step(cfg)


def smoke_audio_batch(cfg: ExperimentConfig, num: int, *, seed: int = 0,
                      device: DeviceLike = None) -> AudioBatch:
    """``num`` seeded int16 utterances of 4-6 s with random targets of
    10-30 tokens, padded to the smallest multiple of 16 that holds the
    longest target and its <eos> (the JAX pipeline's adaptive width)."""
    audio, lens = make_utterances(num, min_seconds=4.0, max_seconds=6.0, seed=seed)
    rng = np.random.default_rng(seed + 1)
    v = cfg.model.vocab_size
    targets = [rng.integers(4, v, size=int(n)).tolist()
               for n in rng.integers(10, 31, size=num)]
    width = -(-(max(len(t) for t in targets) + 1) // 16) * 16
    tin, tout, tlens = pad_targets(targets, width)
    return AudioBatch(audio=audio, sample_lens=lens, targets_in=tin, targets_out=tout,
                      target_lens=tlens, valid=np.ones(num, bool)).to(resolve_device(device))


def smoke_train_batch(device: DeviceLike = None) -> SmokeTrainBatch:
    """The train path's batch: the ``base`` preset (bf16 compute over f32
    master weights, bf16 Adam moments, dropout 0.1) with seeded random
    weights (generator seed 0) and ``train.batch_size`` (64) utterances."""
    cfg = get_config("base")
    state = create_train_state(cfg, device=device, seed=0)
    batch = smoke_audio_batch(cfg, cfg.train.batch_size, device=state.device)
    return SmokeTrainBatch(cfg, state, batch, make_audio_train_step(cfg))


_GROUPS = (("flash_fwd", "flash_fwd"), ("flash_bwd_dkv", "flash_bwd_dkv"),
           ("flash_bwd_dq", "flash_bwd_dq"), ("fused_adam", "adam_kernel"),
           ("stft_mel", "stft_mel"), ("gemm", "gemm"), ("gemm", "nvjet"),
           ("gemm", "cutlass"), ("conv", "conv"), ("norm", "norm"),
           ("softmax", "softmax"), ("reduce", "reduce"))


def _group(name: str) -> str:
    low = name.lower()
    return next((g for g, key in _GROUPS if key in low), "elementwise/other")


def main() -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    smoke = smoke_train_batch()
    state, batch, step = smoke.state, smoke.batch, smoke.step
    for _ in range(WARMUP_STEPS):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    groups = collections.defaultdict(float)
    for name, (_, t) in by_name.items():
        groups[_group(name)] += t / 1e3
    audio_s = float(m["audio_seconds"])
    wall = statistics.median(walls)
    print(json.dumps({"profile_train": {
        "device": torch.cuda.get_device_name(0),
        "wall_s_median": wall, "wall_s": walls, "wall_s_profiled": wall_prof,
        "audio_s_per_s": audio_s / wall,
        "target_tokens_per_s": float(m["tokens"]) / wall,
        "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
        "device_events": len(kernels),
        "device_busy_s": busy / 1e6,
        "device_idle_share": 1.0 - busy / 1e6 / wall_prof,
        "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:90], "calls": c, "total_ms": t / 1e3}
                        for n, (c, t) in top]}}), flush=True)


if __name__ == "__main__":
    main()
