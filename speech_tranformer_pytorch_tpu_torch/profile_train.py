"""Where the time of one train step goes, on a CUDA card.

    python -m speech_tranformer_pytorch_tpu_torch.profile_train \
        [--preset large] [--set model.remat=False] [--seconds 20,30] [--tokens 20,60]
    torchrun --nproc-per-node 4 -m speech_tranformer_pytorch_tpu_torch.profile_train \
        --preset sharded --mesh 1,4 --set train.batch_size=16 --seconds 20,30 \
        --tokens 20,60

Runs the smoke train path (``smoke_train_batch``: by default the ``base``
preset at full width and depth, seeded random weights, dropout 0.1, 64
int16 utterances of 4-6 s with 10-30 random target tokens; ``--preset``,
``--set``, ``--seconds`` and ``--tokens`` pick another preset, overrides,
utterance and target lengths, ``train.batch_size`` utterances each:
``--preset large --seconds 20,30 --tokens 20,60`` is ``chip_smoke.py``'s
``large_train_path`` batch) for 3 warm-up steps and 10
timed steps, then one step under ``utils/profiling.trace``, whose Chrome
trace goes to ``--trace-dir``. Prints one JSON line: the median step wall
time, the device's busy time (union of kernel intervals) and idle share in
the profiled step, the NCCL kernels' time and what of it no compute kernel
hides, its device events, device time by kernel group (the port's kernels,
GEMMs, convolutions, norms, the rest) and the kernels that take the most
device time. With ``--mesh DATA,MODEL`` under ``torchrun`` each rank
profiles its share of the sharded step (``parallel/sharding``;
``train.batch_size`` utterances per data rank) and prints its own line.
``chip_smoke.py`` trains on the same batch through ``smoke_train_batch``,
so the trace describes the path it checks.
"""

from __future__ import annotations

import collections
import dataclasses
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
from .train import TrainState, create_train_state
from .utils.profiling import busy_us, device_ops

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


_GROUPS = (("nccl", "nccl"), ("flash_fwd", "flash_fwd"), ("flash_bwd_dkv", "flash_bwd_dkv"),
           ("flash_bwd_dq", "flash_bwd_dq"), ("fused_adam_master", "adam_master_kernel"),
           ("fused_adam", "adam_kernel"),
           ("stft_mel", "stft_mel"), ("gemm", "gemm"), ("gemm", "nvjet"),
           ("gemm", "cutlass"), ("conv", "conv"), ("norm", "norm"),
           ("softmax", "softmax"), ("reduce", "reduce"))


def _group(name: str) -> str:
    low = name.lower()
    return next((g for g, key in _GROUPS if key in low), "elementwise/other")


def _trace_summary(prof, wall: float) -> dict:
    """Device time of a profiled step: busy (the union of kernel
    intervals), idle share of ``wall``, NCCL kernels' time and what of it
    no compute kernel overlaps, by kernel group and the top kernels."""
    kernels, busy = device_ops(prof)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    compute = [e for e in kernels if "nccl" not in e.name.lower()]
    busy, compute_s = busy / 1e6, busy_us(compute) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    groups = collections.defaultdict(float)
    for name, (_, t) in by_name.items():
        groups[_group(name)] += t / 1e3
    return {"device_events": len(kernels), "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "compute_busy_s": compute_s, "nccl_busy_s": busy_us(nccl) / 1e6,
            "nccl_exposed_s": busy - compute_s,
            "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": n[:90], "calls": c, "total_ms": t / 1e3}
                            for n, (c, t) in top]}


def _mesh_smoke(preset: str, overrides: dict, mesh_arg: str, seconds, tokens):
    """This rank's share of a sharded train step on a (data, model) mesh
    of a ``torchrun`` launch: (cfg, mesh, state, local batch, step). The
    batch is ``train.batch_size`` utterances per data rank, made whole on
    every rank from the same seed and split by ``data_rows``."""
    from .models import SpeechTransformer
    from .parallel.mesh import make_mesh
    from .parallel.sharding import data_rows, make_sharded_audio_train_step

    dp, tp = (int(x) for x in mesh_arg.split(","))
    cfg = get_config(preset, **{**overrides, "mesh.model_axis": tp})
    mesh = make_mesh(cfg.mesh)
    if mesh.dp != dp:
        raise ValueError(f"--mesh {mesh_arg} needs {dp * tp} ranks, the launch "
                         f"has {mesh.world}")
    whole = SpeechTransformer(cfg.model).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    gbatch = smoke_audio_batch(cfg, cfg.train.batch_size * mesh.dp, device="cpu",
                               seconds=seconds, tokens=tokens)
    local = AudioBatch(*(data_rows(getattr(gbatch, f.name), mesh)
                         for f in dataclasses.fields(gbatch))).to(mesh.device)
    state = create_train_state(cfg, params=whole, mesh=mesh)
    return cfg, mesh, state, local, make_sharded_audio_train_step(cfg, mesh)


def main() -> None:
    import argparse

    from .cli_common import parse_overrides
    from .utils.profiling import trace

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="base")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="config override, e.g. --set model.remat=False")
    ap.add_argument("--seconds", default="4,6", help="utterance lengths, MIN,MAX")
    ap.add_argument("--tokens", default="10,30", help="target lengths, MIN,MAX")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="profile the sharded step on a (data, model) mesh, one "
                         "rank a card under torchrun")
    ap.add_argument("--trace-dir", default="traces",
                    help="directory for the Chrome trace of the profiled step")
    args = ap.parse_args()
    lo, hi = (float(x) for x in args.seconds.split(","))
    tokens = tuple(int(x) for x in args.tokens.split(","))
    overrides = parse_overrides(args.set)
    if args.mesh:
        cfg, mesh, state, batch, step = _mesh_smoke(args.preset, overrides, args.mesh,
                                                    (lo, hi), tokens)
        dev, rank = mesh.device, mesh.rank
    else:
        smoke = smoke_train_batch(preset=args.preset, overrides=overrides,
                                  seconds=(lo, hi), tokens=tokens)
        cfg, state, batch, step = smoke.cfg, smoke.state, smoke.batch, smoke.step
        dev, rank = state.device, 0
    for _ in range(WARMUP_STEPS):
        state, m = step(state, batch)
    torch.cuda.synchronize(dev)
    walls = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)

    with trace(args.trace_dir, name=f"train_step_rank{rank}") as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize(dev)
        wall_prof = time.perf_counter() - t0

    audio_s = float(m["audio_seconds"])
    wall = statistics.median(walls)
    print(json.dumps({"profile_train": {
        "device": torch.cuda.get_device_name(dev), "preset": args.preset,
        "overrides": args.set, "seconds": [lo, hi], "tokens": list(tokens),
        "mesh": args.mesh, "rank": rank,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "wall_s_median": wall, "wall_s": walls, "wall_s_profiled": wall_prof,
        "audio_s_per_s": audio_s / wall,
        "target_tokens_per_s": float(m["tokens"]) / wall,
        "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
        **_trace_summary(prof, wall_prof)}}), flush=True)
    if args.mesh:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
