#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. the card's name and power limit, as nvidia-smi prints them;
  2. build the CUDA kernels from ``speech_tranformer_pytorch_tpu_torch/csrc``
     and check each against its plain PyTorch version on the card, at the
     main path's shapes, with timings (CUDA events) and the roofline bound;
  3. the main path: ``Recognizer.decode_batch`` at the ``base`` preset (full
     width, bf16, seeded random weights) serving 8 int16 utterances of 4-6 s
     with beam 5 and max_len 100, with the kernels' launch counts;
  4. the same path in float32 on 2 utterances, on the card with the kernels
     and on the CPU with the plain versions: hypotheses must be identical
     and the first step's logits within 1e-3;
  5. one JSON line per kernel set, then ``{"ok": true, "device": ...}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time


H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores, same sheet
PKG = "speech_tranformer_pytorch_tpu_torch"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(torch, fn, reps: int = 20, rounds: int = 5) -> float:
    """Median device time of one call, in ms. Each round enqueues ``reps``
    calls behind a sleeping kernel, so the events time the device's work
    back to back and not the host's launch pace."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def check_close(name, got, want, atol, rtol) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max())
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} values outside atol={atol} "
                             f"rtol={rtol}; max abs err {err}")
    return err


def check_fbank(torch, dev):
    import numpy as np
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.data.features import (
        make_mel_matrix, num_frames)
    from speech_tranformer_pytorch_tpu_torch.kernels import stft_mel
    from speech_tranformer_pytorch_tpu_torch.profile_decode import smoke_audio

    cfg = get_config("base").features
    audio, _ = smoke_audio()       # the main path's utterances
    wave = torch.from_numpy(audio).to(dev).float() * (1.0 / 32768.0)
    b, s = wave.shape
    n = num_frames(s, cfg.frame_length, cfg.frame_shift)
    got = stft_mel.log_mel_cuda(wave, cfg, n)
    want = stft_mel.log_mel_reference(wave, cfg, n)
    torch.cuda.synchronize()
    err = check_close("stft_mel", got, want, 1e-3, 1e-3)
    ms = device_ms(torch, lambda: stft_mel.log_mel_cuda(wave, cfg, n))
    plain_ms = device_ms(torch, lambda: stft_mel.log_mel_reference(wave, cfg, n))
    # The least work of the function, not of this kernel's DFT-as-matmul:
    # per frame, DC removal + pre-emphasis + window (5 ops a sample), a
    # real FFT (2.5 N log2 N), the power (3 a bin), the mel filters'
    # nonzero weights (2 each) and max + log (2 a mel bin). Bytes: the
    # waveform in, the features out, the window and the nonzero weights.
    L, nfft, m = cfg.frame_length, cfg.fft_length, cfg.num_mel_bins
    nnz = int(np.count_nonzero(make_mel_matrix(
        m, nfft, cfg.sample_rate, cfg.low_freq, cfg.high_freq)))
    nbytes = 4 * (b * s + b * n * m + L + nnz)
    flops = b * n * (5 * L + 2.5 * nfft * math.log2(nfft)
                     + 3 * (nfft // 2 + 1) + 2 * nnz + 2 * m)
    bound_ms, bound_by = bound(nbytes, flops)
    rec = dict(name="stft_mel", source=f"{PKG}/csrc/stft_mel.cu",
               replaces="speech_tranformer_pytorch_tpu/kernels/stft_mel.py:80",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None, shape=[b, s, n])
    emit({"check": rec})
    return rec


def _prune_cases(torch):
    """(name, logits [B·K, V], alive [B, K], k2): the main path's shape, then
    every tie, dead-row and saturation case of the JAX kernel's goldens."""
    g = torch.Generator().manual_seed(1)
    normal = lambda *shape: torch.randn(*shape, generator=g)
    zeros = torch.zeros
    more = zeros(2, 64)
    more[0] = 5.0
    spikes = normal(6, 33)
    spikes[:, 0], spikes[:, 1] = 100.0, 99.0
    return [
        ("main_path", normal(40, 4336) * 3.0, normal(8, 5) * 5.0, 10),
        ("neg_inf_alive", normal(8, 50), torch.tensor([[0.0] + [-1e9] * 3] * 2), 8),
        ("ties_within_row", zeros(2, 40), torch.tensor([[0.0, -0.5]]), 4),
        ("ties_across_beams", zeros(3, 16), zeros(1, 3), 6),
        ("more_than_k2_ties", more, torch.tensor([[0.0, -1.0]]), 5),
        ("special_token_masking", spikes, zeros(2, 3), 4),
        ("tiny_vocab_saturation", normal(2, 6), torch.tensor([[0.0, -1e9]]), 6),
        ("all_dead_rows", normal(6, 8), torch.full((2, 3), -1e9), 6),
    ]


def check_beam_prune(torch, dev):
    from speech_tranformer_pytorch_tpu_torch.kernels import beam_prune
    from speech_tranformer_pytorch_tpu_torch.ops.masks import NEG_INF

    main = None
    for name, logits, alive, k2 in _prune_cases(torch):
        logits, alive = logits.to(dev), alive.to(dev)
        got_v, got_i = beam_prune.candidate_topk_cuda(logits, alive, k2=k2)
        want_v, want_i = beam_prune.candidate_topk_reference(logits, alive, k2=k2)
        torch.cuda.synchronize()
        if not torch.equal(got_i.cpu(), want_i.cpu()):
            raise AssertionError(f"beam_prune[{name}]: indices differ\n"
                                 f"{got_i.cpu()}\n{want_i.cpu()}")
        err = check_close(f"beam_prune[{name}]", got_v, want_v, 1e-6, 1e-6)
        emit({"check": {"name": f"beam_prune[{name}]", "max_abs_err": err}})
        if main is None:
            main = (logits, alive, k2, err)
    logits, alive, k2, err = main

    def library():   # a yardstick only: the port never calls torch.topk
        lp = torch.log_softmax(logits, dim=-1)
        lp[:, 0] = NEG_INF
        lp[:, 1] = NEG_INF
        cand = alive[:, :, None] + lp.reshape(alive.shape[0], alive.shape[1], -1)
        return torch.topk(cand.reshape(alive.shape[0], -1), k2)

    ms = device_ms(torch, lambda: beam_prune.candidate_topk_cuda(logits, alive, k2=k2))
    plain_ms = device_ms(torch, lambda: beam_prune.candidate_topk_reference(
        logits, alive, k2=k2))
    library_ms = device_ms(torch, library)
    bk, v = logits.shape
    nbytes = 4 * (bk * v + bk) + 8 * alive.shape[0] * k2
    bound_ms, bound_by = bound(nbytes, bk * v * 7)
    rec = dict(name="beam_prune", source=f"{PKG}/csrc/beam_prune.cu",
               replaces="speech_tranformer_pytorch_tpu/kernels/beam_prune.py:36",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms, shape=[bk, v, k2])
    emit({"check": rec})
    return rec


def check_lineage(torch, dev):
    from speech_tranformer_pytorch_tpu_torch.kernels import lineage_attention as la

    b, k, L, h, d = 8, 5, 100, 8, 64
    g = torch.Generator().manual_seed(2)

    def inputs(index, dtype):
        q = torch.randn(b * k, 1, h, d, generator=g)
        ck = torch.randn(b * k, L, h, d, generator=g)
        cv = torch.randn(b * k, L, h, d, generator=g)
        lin = torch.randint(0, k, (b, k, L), generator=g, dtype=torch.int32)
        lin[:, :, index:] = torch.arange(k, dtype=torch.int32)[None, :, None]
        return [t.to(dev, dtype) for t in (q, ck, cv)] + [lin.to(dev)]

    errs = {}
    for dtype, atol in ((torch.float32, 2e-6), (torch.bfloat16, 2e-2)):
        for index in (0, 17, 49, 99):
            args = inputs(index, dtype)
            got = la.lineage_attention_cuda(*args, index, k)
            want = la.lineage_attention_reference(*args, index, k)
            torch.cuda.synchronize()
            if got.dtype != dtype:
                raise AssertionError(f"lineage_attention: dtype {got.dtype}")
            name = f"lineage_attention[{str(dtype)[6:]},index={index}]"
            errs[(dtype, index)] = check_close(name, got, want, atol, 1e-5)
            emit({"check": {"name": name, "max_abs_err": errs[(dtype, index)]}})
    # Timed at the main path's dtype, mid-decode (index 49 of L=100).
    index = 49
    args = inputs(index, torch.bfloat16)
    ms = device_ms(torch, lambda: la.lineage_attention_cuda(*args, index, k))
    plain_ms = device_ms(torch, lambda: la.lineage_attention_reference(*args, index, k))
    lin = args[3][:, :, :index + 1].long()
    distinct = int(torch.zeros(b, k, index + 1, device=dev).scatter_(1, lin, 1.0).sum())
    nbytes = (2 * distinct * h * d * 2          # selected K and V rows, bf16
              + 2 * b * k * h * d * 2           # q in, out
              + b * k * (index + 1) * 4)        # lineage columns read
    flops = b * k * h * (index + 1) * (4 * d + 5)
    bound_ms, bound_by = bound(nbytes, flops)
    rec = dict(name="lineage_attention", source=f"{PKG}/csrc/lineage_attention.cu",
               replaces="speech_tranformer_pytorch_tpu/kernels/lineage_attention.py:43",
               max_abs_err=errs[(torch.bfloat16, index)],
               max_abs_err_f32=max(v for (dt, _), v in errs.items()
                                   if dt == torch.float32),
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=None, shape=[b * k, L, h, d, index])
    emit({"check": rec})
    return rec


def main_path(torch, dev):
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.profile_decode import DECODE, smoke_batch

    # The batch profile_decode.py traces: base preset, seeded random
    # weights, 8 int16 utterances of 4-6 s, beam 5, max_len 100.
    cfg, params, rec, audio, lens = smoke_batch(dev)
    warm = rec.decode_result(audio, lens, **DECODE)
    if not bool(torch.isfinite(warm.scores[:, 0]).all()):
        raise AssertionError(f"non-finite best scores {warm.scores[:, 0]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    interface.reset_launch_counts()
    t0 = time.perf_counter()
    hyps = rec.decode_batch(audio, lens, **DECODE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = interface.launch_counts()

    steps = rec.last_steps
    v = cfg.model.vocab_size
    if len(hyps) != len(lens) or any(not 0 <= t < v or t == 2 for h in hyps for t in h):
        raise AssertionError(f"malformed hypotheses {hyps}")
    want = {"stft_mel": 1, "beam_prune": steps,
            "lineage_attention": cfg.model.num_decoder_layers * steps}
    if steps <= 0 or counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    audio_s = float(lens.sum()) / cfg.features.sample_rate
    emit({"main_path": {
        "preset": "base", "dtype": cfg.model.dtype, "utterances": len(lens),
        "beam": DECODE["beam_size"], "max_len": DECODE["max_len"],
        "wall_s": wall, "audio_s": audio_s,
        "rtf": wall / audio_s, "decode_steps": steps,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "launches": counts, "hyp_lens": [len(h) for h in hyps]}})
    return counts, params, audio, lens


def card_vs_cpu(torch, dev, params, audio, lens):
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.data.features import extract_features
    from speech_tranformer_pytorch_tpu_torch.decoding import best_hypotheses
    from speech_tranformer_pytorch_tpu_torch.profile_decode import DECODE
    from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer

    cfg = get_config("base", **{"model.dtype": "float32",
                                "features.output_dtype": "float32"})
    beam, max_len = DECODE["beam_size"], DECODE["max_len"]
    lens2 = lens[:2]
    audio2 = audio[:2, :int(lens2.max())]
    out = {}
    for where in (dev, torch.device("cpu")):
        rec = Recognizer(cfg, params, device=where)
        result = rec.decode_result(audio2, lens2, **DECODE)
        with torch.no_grad():
            feats, flens = extract_features(audio2, lens2, cfg.features, device=where)
            memory, mem_lens = rec.model.encode(feats, flens)
            cache = rec.model.init_cache(memory, max_len, beam)
            lineage = torch.arange(beam, dtype=torch.int32, device=where)[
                None, :, None].expand(2, beam, max_len).contiguous()
            sos = torch.full((2 * beam,), 1, dtype=torch.int32, device=where)
            logits, _ = rec.model.decode_step(sos, 0, cache, mem_lens, beam, lineage)
        out[where.type] = (best_hypotheses(result), result.scores.cpu(), logits.cpu())
    (hyp_g, sc_g, lg_g), (hyp_c, sc_c, lg_c) = out["cuda"], out["cpu"]
    logit_err = float((lg_g - lg_c).abs().max())
    gaps = [float(sc_c[i, 0] - sc_c[i, 1]) for i in range(sc_c.shape[0])]
    emit({"card_vs_cpu": {"hyps_equal": hyp_g == hyp_c, "first_step_logit_err": logit_err,
                          "top2_score_gap_cpu": gaps, "hyp_lens": [len(h) for h in hyp_g],
                          "score_err": float((sc_g - sc_c).abs().max())}})
    if hyp_g != hyp_c:
        raise AssertionError(f"card and CPU hypotheses differ: {hyp_g} vs {hyp_c}")
    if not logit_err <= 1e-3:
        raise AssertionError(f"first-step logits differ by {logit_err}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from speech_tranformer_pytorch_tpu_torch.device import resolve_device
    from speech_tranformer_pytorch_tpu_torch.kernels import _build

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    _build.build(verbose=True)
    emit({"build_s": time.perf_counter() - t0})

    recs = [check_fbank(torch, dev), check_beam_prune(torch, dev),
            check_lineage(torch, dev)]
    counts, params, audio, lens = main_path(torch, dev)
    card_vs_cpu(torch, dev, params, audio, lens)

    kernels = []
    for r in recs:
        kernels.append({"name": r["name"], "route": "cuda", "source": r["source"],
                        "replaces": r["replaces"], "launches": counts[r["name"]],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
