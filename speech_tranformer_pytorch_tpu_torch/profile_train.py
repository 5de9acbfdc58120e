"""Where the time of one train step goes, on a CUDA card.

    python -m speech_tranformer_pytorch_tpu_torch.profile_train \
        [--preset large] [--set model.remat=False] [--seconds 20,30] [--tokens 20,60]

Runs the smoke train path (``smoke_train_batch``: by default the ``base``
preset at full width and depth, seeded random weights, dropout 0.1, 64
int16 utterances of 4-6 s with 10-30 random target tokens; ``--preset``,
``--set``, ``--seconds`` and ``--tokens`` pick another preset, overrides,
utterance and target lengths, ``train.batch_size`` utterances each:
``--preset large --seconds 20,30 --tokens 20,60`` is ``chip_smoke.py``'s
``large_train_path`` batch) for 3 warm-up steps and 10
timed steps, then one step under ``torch.profiler``. Prints one JSON line: the
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
from typing import Callable, NamedTuple, Optional

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
                      device: DeviceLike = None, seconds=(4.0, 6.0),
                      tokens=(10, 30)) -> AudioBatch:
    """``num`` seeded int16 utterances of ``seconds`` (4-6 s) with random
    targets of ``tokens`` (10-30) tokens, padded to the smallest multiple of
    16 that holds the longest target and its <eos> (the JAX pipeline's
    adaptive width)."""
    audio, lens = make_utterances(num, min_seconds=seconds[0], max_seconds=seconds[1],
                                  seed=seed)
    rng = np.random.default_rng(seed + 1)
    v = cfg.model.vocab_size
    targets = [rng.integers(4, v, size=int(n)).tolist()
               for n in rng.integers(tokens[0], tokens[1] + 1, size=num)]
    width = -(-(max(len(t) for t in targets) + 1) // 16) * 16
    tin, tout, tlens = pad_targets(targets, width)
    return AudioBatch(audio=audio, sample_lens=lens, targets_in=tin, targets_out=tout,
                      target_lens=tlens, valid=np.ones(num, bool)).to(resolve_device(device))


def smoke_train_batch(device: DeviceLike = None, preset: str = "base",
                      overrides: Optional[dict] = None, seconds=(4.0, 6.0),
                      tokens=(10, 30)) -> SmokeTrainBatch:
    """A train path's batch: by default the ``base`` preset (bf16 compute
    over f32 master weights, bf16 Adam moments, dropout 0.1) with seeded
    random weights (generator seed 0) and ``train.batch_size`` (64)
    utterances of 4-6 s; ``preset``, ``overrides``, ``seconds`` and
    ``tokens`` choose another."""
    cfg = get_config(preset, **(overrides or {}))
    state = create_train_state(cfg, device=device, seed=0)
    batch = smoke_audio_batch(cfg, cfg.train.batch_size, device=state.device,
                              seconds=seconds, tokens=tokens)
    return SmokeTrainBatch(cfg, state, batch, make_audio_train_step(cfg))


_GROUPS = (("flash_fwd", "flash_fwd"), ("flash_bwd_dkv", "flash_bwd_dkv"),
           ("flash_bwd_dq", "flash_bwd_dq"), ("fused_adam_master", "adam_master_kernel"),
           ("fused_adam", "adam_kernel"),
           ("stft_mel", "stft_mel"), ("gemm", "gemm"), ("gemm", "nvjet"),
           ("gemm", "cutlass"), ("conv", "conv"), ("norm", "norm"),
           ("softmax", "softmax"), ("reduce", "reduce"))


def _group(name: str) -> str:
    low = name.lower()
    return next((g for g, key in _GROUPS if key in low), "elementwise/other")


def main() -> None:
    import argparse

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .cli_common import parse_overrides

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="base")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="config override, e.g. --set model.remat=False")
    ap.add_argument("--seconds", default="4,6", help="utterance lengths, MIN,MAX")
    ap.add_argument("--tokens", default="10,30", help="target lengths, MIN,MAX")
    args = ap.parse_args()
    lo, hi = (float(x) for x in args.seconds.split(","))
    tokens = tuple(int(x) for x in args.tokens.split(","))
    smoke = smoke_train_batch(preset=args.preset, overrides=parse_overrides(args.set),
                              seconds=(lo, hi), tokens=tokens)
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
        "device": torch.cuda.get_device_name(0), "preset": args.preset,
        "overrides": args.set, "seconds": [lo, hi], "tokens": list(tokens),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
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
