"""Where the time of one served batch goes, on a CUDA card.

    python -m speech_tranformer_pytorch_tpu_torch.profile_decode [--int8]
        [--preset librispeech_conformer|whisper_large_v3] [--eager-prologue]

Runs the smoke main path (``smoke_batch``: ``base`` preset, or
``--preset``'s, seeded random weights, 8 int16 utterances of 4-6 s, beam 5,
max_len 100; with ``--int8`` int8 weights and an int8 cross-K/V cache)
once to warm up, once timed, then once under ``torch.profiler``. With
``--eager-prologue`` the profiled call finds no graph of its shape, so its
prologue (features, encoder, caches) runs eagerly and its spans show:
``st.features``, ``st.encode``, for a Conformer ``st.encode.relpos``
and ``st.encode.conv``, and for Whisper the prompt's forced steps,
``st.decode.prompt``. Prints one JSON line:
the wall time, the device's busy time (union of kernel intervals) and idle
share, kernel launches per decode step, the kernels that take the most
device time, for each of the program's spans (``st.*``,
``utils/profiling.span_stats``) its count, host time, launches per decode
step and the device time its launches caused, and how the profiled call's
decode steps were issued (``kernels/interface.decode_step_counts``: graph
replays, captures, eager steps, and the call prologues replayed, captured
and run eagerly), and how its self K/V rows were written
(``interface.row_write_counts``: inside the lineage kernel, or by
``index_copy_``; one a decoder layer and step, a prompt's forced steps
included). ``chip_smoke.py`` serves
the same batch through ``smoke_batch``, so the trace describes the path
it measures.
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
INT8 = {"decode.int8_weights": True, "decode.int8_kv_cache": True}


class SmokeBatch(NamedTuple):
    cfg: ExperimentConfig
    params: Dict[str, torch.Tensor]   # float32 state_dict, on the CPU
    recognizer: Recognizer
    audio: np.ndarray                 # [8, S] int16
    lens: np.ndarray                  # [8] valid sample counts


def smoke_audio():
    """8 seeded int16 utterances of 4-6 s: (audio [8, S], lens [8])."""
    return make_utterances(8, min_seconds=4.0, max_seconds=6.0, seed=0)


def smoke_batch(device: DeviceLike = None, *, int8: bool = False,
                preset: str = "base") -> SmokeBatch:
    """The main path's batch: the ``base`` preset (or ``preset``) with
    seeded random weights (generator seed 0) and ``smoke_audio``, served
    by a ``Recognizer`` on ``device`` (with ``int8``: int8 weights and int8
    cross-K/V cache); decode it with ``DECODE``."""
    cfg = get_config(preset, **(INT8 if int8 else {}))
    params = SpeechTransformer(cfg.model).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    audio, lens = smoke_audio()
    return SmokeBatch(cfg, params, Recognizer(cfg, params, device=device),
                      audio, lens)


def main() -> None:
    import argparse

    from torch.profiler import ProfilerActivity, profile

    from .kernels import interface
    from .utils.profiling import device_ops, span_stats

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights and int8 cross-K/V cache")
    ap.add_argument("--preset", default="base")
    ap.add_argument("--eager-prologue", action="store_true",
                    help="profile a call whose prologue runs eagerly (its spans show)")
    args = ap.parse_args()
    int8 = args.int8
    batch = smoke_batch(int8=int8, preset=args.preset)
    rec = batch.recognizer
    rec.decode_batch(batch.audio, batch.lens, **DECODE)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    rec.decode_batch(batch.audio, batch.lens, **DECODE)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0

    if args.eager_prologue:
        from .decoding import beam_graph

        beam_graph._GRAPHS.pop(rec.model, None)
    interface.reset_decode_step_counts()
    interface.reset_row_write_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec.decode_batch(batch.audio, batch.lens, **DECODE)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0

    kernels, busy = device_ops(prof)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    steps = rec.last_steps
    spans = span_stats(prof.profiler.kineto_results.events())
    print(json.dumps({"profile": {
        "device": torch.cuda.get_device_name(0), "preset": args.preset, "int8": int8,
        "wall_s": wall_plain, "wall_s_profiled": wall_prof, "decode_steps": steps,
        "device_events": len(kernels),
        "launches_per_step": len(kernels) / max(steps, 1),
        "device_busy_s": busy / 1e6,
        "device_idle_share": 1.0 - busy / 1e6 / wall_prof,
        "top_kernels": [{"name": n[:90], "calls": c, "total_ms": t / 1e3}
                        for n, (c, t) in top],
        "spans": {n: {"count": v.count, "host_ms": v.host_s * 1e3,
                      "launches_per_step": v.launches / max(steps, 1),
                      "device_ms": v.device_s * 1e3}
                  for n, v in sorted(spans.items())},
        "decode_step_counts": interface.decode_step_counts(),
        "row_writes": interface.row_write_counts()}}), flush=True)


if __name__ == "__main__":
    main()
