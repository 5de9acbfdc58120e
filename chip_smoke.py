#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py [--phases name,name,...]

Phases (any failure exits non-zero before the final line):
  1. the card's name and power limit, as nvidia-smi prints them;
  2. build the CUDA kernels from ``speech_tranformer_pytorch_tpu_torch/csrc``
     and check each against its plain PyTorch version on the card, at the
     main paths' shapes, with timings (CUDA events) and the roofline bound:
     fbank (``check_fbank``: the FFT kernel at the serving and train
     batches and the ``large`` train batch (96 utterances of 20-30 s),
     hann without pre-emphasis or log, hamming, an all-zero
     utterance, a partial last tile, and the DFT kernel at fft_length 400;
     every case bit-identical on a second call; timed at both batches),
     beam prune (``check_beam_prune``: the JAX goldens' tie, dead-row and
     saturation cases, K 8 with k2 16, K 10 with k2 20 on the two-launch
     kernel, V 5000, V 4337 and 32 utterances; indices exact, every case
     bit-identical on a second call; one device kernel a call on the main
     shape), lineage attention (beam 5, a shared history,
     L 256 and K = 1), decode cross-attention (``check_cross_attention``:
     every length bucket of both serving cells, greedy K = 1, H 4 and 16
     at D 128, an utterance with no valid frame, the int8 path's
     frame-major cache; bit-identical on a second call, timed beside the
     route it replaced), flash attention forward, dK/dV and dQ
     (``check_flash``: the ``base`` and ``large`` train shapes,
     zero-length rows, D 20, T' 750 and D 128, causal and not, and the
     bf16 forward and backward bit-identical on a second call), the fused
     Adam (``check_adam``: at the ``base`` tree and, classic and with its
     master-weights variant, at the ``large`` tree; the variant
     bit-identical to its plain version and run to run),
     the int8 matmul (``check_int8_matmul``: every
     shape bit-identical on a second call, timed at the decode and
     ``init_cache`` shapes) and the fused int8 feed-forward
     (``check_int8_ffn``: every shape bit-identical on a second call,
     timed at the beam-5 and greedy decode shapes); lineage attention is
     bit-identical on a second call in every case and timed at three
     decode indices and at K = 1;
  3. the beam step replayed as CUDA graphs (``graph_decode``): the
     ``base`` beam-5 float and int8 paths on one batch of each shape of
     the serving benchmark's mix, graph and eager searches equal in
     hypotheses, lengths, steps and scores, with exact launches, one
     capture a shape, a replay a step, the memory peak under the build's,
     and an arena grown shape by shape captured again each time;
     the hybrid CTC/attention search (``ctc_decode``): the CTC prefix
     kernel against its plain version at the `librispeech` cell's shapes,
     then graph against eager hybrid searches of that configuration on a
     batch of each of its buckets, equal, with exact launches;
     then the serving main path: ``Recognizer.decode_batch`` at the ``base``
     preset (full width, bf16, seeded random weights) serving 8 int16
     utterances of 4-6 s with beam 5 and max_len 100, with the kernels'
     exact launch counts, and the same batch decoded in float32 with
     ``use_lineage=False`` (the self cache gathered by beam), token-equal
     to the lineage route; then ``export_path``: the same recognizer
     exported for serving (``serving.export_recognizer``, beam 5 and
     greedy), through bytes and ``load_exported``, equal to the live
     decode with exact launch counts, its export seconds, artifact bytes
     and walls beside the live decode's; then the int8 serving path (``int8_path``): the
     same batch with int8 weights and the int8 cross-K/V cache, at beam 5
     and greedily (beam 1), each with exact launch counts;
  4. each serving path in float32 on 2 utterances, on the card with the
     kernels and on the CPU with the plain versions (``card_vs_cpu``,
     ``int8_card_vs_cpu`` at beam 5 and at beam 1, greedy): hypotheses
     must be identical and the first step's logits within 1e-3;
  5. the train main path (``train_path``): 3 + 10 steps of the ``base``
     preset (full width and depth, bf16 over f32 masters, dropout 0.1) on
     64 int16 utterances, with exact per-step launch counts; then the
     ``large`` preset's (``large_train_path``: full width and depth,
     SpecAugment, layer remat, dropout 0.1, 96 utterances of 20-30 s; 3 +
     10 steps with exact launches; SpecAugment's budgets at step 0; remat
     on against off, loss bit-identical and gradients within 1e-5 of each
     leaf's largest; 3 steps with master weights, the f32 master
     bit-identical to the classic f32 parameters, device events of each;
     ``large`` with master weights and ``librispeech`` through the
     ``Trainer``; each of these runs reports its own launches);
  6. one float32 train step on 2 utterances, card against CPU
     (``train_card_vs_cpu``), and the overfit anchor: 300 steps of a small
     model on 10 synthetic utterances, then exact beam decoding;
  7. serving and training from files (``manifest_path``): the ``base``
     preset's ``Trainer`` on a WAV manifest (straight with dev evaluations
     on a FLAC manifest, dev loss against the bare eval step and
     ``work_dir/best`` checked; stopped at step 3 and resumed, params
     compared; its steps/s against the bare step), then ``load_recognizer``
     and ``decode_manifest`` of the FLAC manifest at beam 5, greedy (from
     ``best``) and int8, with exact launches per step, batch and dev batch;
     then the input pipelines on a FLAC corpus (``pipeline_path``): the
     ``base`` preset's ``Trainer`` at batch 32 with ``data.pipeline``
     "python" and "grain" (host batches hashed equal, losses, parameters
     and launches; a grain run stopped and resumed on the plan's batches),
     the native FLAC decoder bit-equal to the pure-Python one and to the
     PCM written, each route's decode rate, the step walls of both
     pipelines (2, 4 and 8 workers) against the bare step, and
     ``decode_manifest`` at beam 5 with its native CER equal to the plain
     one; and the drive recipe (``drive_recipe``): ``prepare_cli``,
     ``train_cli`` (straight, and halfway then ``--resume``) and
     ``recognize_cli`` as child processes, ending in ``"cer": 0.0``;
  8. the parallel path (``parallel_path``): one NCCL rank per card; the
     ``sharded`` preset at full width and depth trained on a (1, n) mesh
     against the single-device step, sharded beam-5 and greedy decoding
     against the single-device ``Recognizer``, then ``base`` through
     ``Trainer(mesh=...)`` (with dev evaluations; resumed bit-identically) and
     ``decode_manifest(distributed=True)``, with exact launches; the
     ring route of the flash kernels is checked at the ``sharded``
     encoder shape by ``check_ring_blocks``;
  9. one JSON line per kernel set, then ``{"ok": true, "device": ...}``;
     before it ends, whatever phase failed, the run stops the processes it
     started that would outlive it (``stop_started_processes``) and fails
     if one of them was not a multiprocessing helper.
``--phases`` runs a subset (the kernel checks need no main path); with no
arguments every phase runs. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time


H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores, same sheet
H100_BF16_FLOP_PER_S = 989e12   # dense bf16 tensor cores, same sheet
PKG = "speech_tranformer_pytorch_tpu_torch"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _descendants() -> list:
    """``(pid, state, command line)`` of every process below this one, read
    from ``/proc``."""
    parent, info = {}, {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:   # ended while being read
            continue
        fields = stat[stat.rindex(")") + 2:].split()   # after "pid (comm) "
        parent[int(d)], info[int(d)] = int(fields[1]), (fields[0], cmd)
    found, frontier = [], [os.getpid()]
    while frontier:
        top = frontier.pop()
        below = [c for c, p in parent.items() if p == top]
        frontier += below
        found += [(c, *info[c]) for c in below]
    return found


def stop_started_processes() -> list:
    """Ends every process this run started that is still there, and waits
    for it. multiprocessing's fork server (the ``grain`` pipeline's workers
    come from it) and its resource tracker live until they read the end of
    a pipe from this process, so left alone they would end only after it;
    they are stopped here through their own stop methods. Any other live
    process below this one, a pipeline worker too, is a leak: it is
    terminated (killed after 10 s) and returned as ``(pid, command line)``."""
    import multiprocessing.forkserver as forkserver
    import multiprocessing.resource_tracker as resource_tracker
    import signal

    helpers = (forkserver._forkserver._forkserver_pid, resource_tracker._resource_tracker._pid)
    live = lambda: {pid: cmd for pid, state, cmd in _descendants()
                    if state != "Z" and pid not in helpers}
    leaked = sorted(live().items())
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in live().keys() & dict(leaked).keys():
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + 10.0
        while live().keys() & dict(leaked).keys() and time.monotonic() < deadline:
            time.sleep(0.1)
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    for pid, _, _ in _descendants():   # reap this process's ended children
        try:
            os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:
            pass
    return leaked


def bound(nbytes: float, flops: float, peak: float = H100_F32_FLOP_PER_S):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
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


# Fbank: every case within 1e-3 (absolute, plus 1e-3 relative) of the plain
# rfft version, as the JAX goldens (tests/test_stft_mel_kernel.py), and
# bit-identical on a second call (no atomics, no scratch). The cases: the
# served batch and the train batch (povey, pre-emphasis, log); hann with no
# pre-emphasis and no log; hamming; a batch holding one all-zero utterance
# (its rows must equal the plain version's log(LOG_EPS) exactly); 37 frames
# of a 6,167-sample row (a partial last tile, rows off the 16-byte grid);
# fft_length 400, which takes the DFT kernel. Timed at the serving and the
# train shapes, each with its bound.
def _fbank_bound(b, s, n, cfg):
    """The least work of the function, not of a kernel: per frame, DC
    removal + pre-emphasis + window (5 ops a sample), a real FFT
    (2.5 N log2 N), the power (3 a bin), the mel filters' nonzero weights
    (2 each) and max + log (2 a mel bin). Bytes: the waveform in, the
    features out, the window and the nonzero weights."""
    import numpy as np
    from speech_tranformer_pytorch_tpu_torch.data.features import make_mel_matrix

    L, nfft, m = cfg.frame_length, cfg.fft_length, cfg.num_mel_bins
    nnz = int(np.count_nonzero(make_mel_matrix(
        m, nfft, cfg.sample_rate, cfg.low_freq, cfg.high_freq)))
    nbytes = 4 * (b * s + b * n * m + L + nnz)
    flops = b * n * (5 * L + 2.5 * nfft * math.log2(nfft)
                     + 3 * (nfft // 2 + 1) + 2 * nnz + 2 * m)
    return bound(nbytes, flops)


def check_fbank(torch, dev):
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.data.features import LOG_EPS, num_frames
    from speech_tranformer_pytorch_tpu_torch.kernels import stft_mel
    from speech_tranformer_pytorch_tpu_torch.profile_decode import smoke_audio
    from speech_tranformer_pytorch_tpu_torch.profile_train import smoke_audio_batch

    cfg = get_config("base")
    fcfg = cfg.features
    to_wave = lambda a: torch.as_tensor(a).to(dev).float() * (1.0 / 32768.0)
    serve = to_wave(smoke_audio()[0])         # the served batch's utterances
    train = to_wave(smoke_audio_batch(cfg, cfg.train.batch_size,
                                      device=torch.device("cpu")).audio)
    large = to_wave(_large_audio(torch).audio)   # large_train_path's utterances
    zero = serve.clone()
    zero[3] = 0.0
    g = torch.Generator().manual_seed(8)
    ragged = (torch.randn(3, 6167, generator=g) * 0.1).to(dev)
    cases = [("serve", serve, fcfg), ("train", train, fcfg), ("train_large", large, fcfg),
             ("hann,no_preemph,no_log", serve,
              fcfg.replace(window="hann", preemphasis=0.0, use_log=False)),
             ("hamming", serve, fcfg.replace(window="hamming")),
             ("zero_utterance", zero, fcfg),
             ("partial_tile,37_frames", ragged, fcfg),
             ("fft_length=400", serve, fcfg.replace(fft_length=400))]
    errs = {}
    for name, wave, c in cases:
        b, s = wave.shape
        n = num_frames(s, c.frame_length, c.frame_shift)
        got = stft_mel.log_mel_cuda(wave, c, n)
        again = stft_mel.log_mel_cuda(wave, c, n)
        want = stft_mel.log_mel_reference(wave, c, n)
        torch.cuda.synchronize()
        tag = f"stft_mel[{name}]"
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{tag}: {tuple(got.shape)} or non-finite values")
        errs[name] = check_close(tag, got, want, 1e-3, 1e-3)
        rec = {"name": tag, "kernel": stft_mel.kernel_for(c), "shape": [b, s, n],
               "max_abs_err": errs[name], "second_call_bit_equal": bool(torch.equal(got, again))}
        if name == "zero_utterance":
            floor = math.log(LOG_EPS)
            rec["zero_rows_equal_plain"] = bool(torch.equal(got[3], want[3]))
            rec["zero_rows_max_dev_from_log_floor"] = float((got[3] - floor).abs().max())
            if not rec["zero_rows_equal_plain"]:
                raise AssertionError(f"{tag}: the all-zero utterance's rows differ "
                                     f"from the plain version's {float(want[3, 0, 0])}")
        emit({"check": rec})
        if not rec["second_call_bit_equal"]:
            raise AssertionError(f"{tag}: differs on a second call")
    timed = {}
    for name, wave in (("serve", serve), ("train", train), ("train_large", large)):
        b, s = wave.shape
        n = num_frames(s, fcfg.frame_length, fcfg.frame_shift)
        bound_ms, bound_by = _fbank_bound(b, s, n, fcfg)
        timed[name] = dict(
            ms=device_ms(torch, lambda: stft_mel.log_mel_cuda(wave, fcfg, n)),
            plain_ms=device_ms(torch, lambda: stft_mel.log_mel_reference(wave, fcfg, n)),
            bound_ms=bound_ms, bound_by=bound_by, shape=[b, s, n])
        emit({"check": {"name": f"stft_mel_timing[{name}]", **timed[name]}})
    main = timed["serve"]
    rec = dict(name="stft_mel", source=f"{PKG}/csrc/stft_mel.cu",
               replaces="speech_tranformer_pytorch_tpu/kernels/stft_mel.py:80",
               max_abs_err=max(errs.values()), ms=main["ms"], plain_ms=main["plain_ms"],
               bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=None,
               shape=main["shape"], train=timed["train"], train_large=timed["train_large"])
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
        ("K8,k2=16", normal(32, 4336) * 3.0, normal(4, 8) * 5.0, 16),
        ("K10,k2=20", normal(20, 4336) * 3.0, normal(2, 10) * 5.0, 20),
        ("V5000", normal(40, 5000) * 3.0, normal(8, 5) * 5.0, 10),
        ("V4337", normal(40, 4337) * 3.0, normal(8, 5) * 5.0, 10),
        ("32_utterances", normal(160, 4336) * 3.0, normal(32, 5) * 5.0, 10),
    ]


def device_kernels_per_call(torch, fn) -> int:
    """Device kernels one call of ``fn`` launches, from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    from speech_tranformer_pytorch_tpu_torch.utils.profiling import device_ops

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return len(device_ops(prof)[0])


def check_beam_prune(torch, dev):
    from speech_tranformer_pytorch_tpu_torch.kernels import beam_prune
    from speech_tranformer_pytorch_tpu_torch.ops.masks import NEG_INF

    main, errs = None, []
    for name, logits, alive, k2 in _prune_cases(torch):
        logits, alive = logits.to(dev), alive.to(dev)
        got_v, got_i = beam_prune.candidate_topk_cuda(logits, alive, k2=k2)
        want_v, want_i = beam_prune.candidate_topk_reference(logits, alive, k2=k2)
        torch.cuda.synchronize()
        if not torch.equal(got_i.cpu(), want_i.cpu()):
            raise AssertionError(f"beam_prune[{name}]: indices differ\n"
                                 f"{got_i.cpu()}\n{want_i.cpu()}")
        err = check_close(f"beam_prune[{name}]", got_v, want_v, 1e-6, 1e-6)
        again_v, again_i = beam_prune.candidate_topk_cuda(logits, alive, k2=k2)
        same = bool(torch.equal(got_v, again_v) and torch.equal(got_i, again_i))
        emit({"check": {"name": f"beam_prune[{name}]", "max_abs_err": err,
                        "plan": beam_prune.plan(alive.shape[1], k2, logits.shape[1]),
                        "second_call_bit_equal": same}})
        if not same:
            raise AssertionError(f"beam_prune[{name}]: differs on a second call")
        errs.append(err)
        if main is None:
            main = (logits, alive, k2)
    logits, alive, k2 = main
    err = max(errs)

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
    kernels_per_call = device_kernels_per_call(
        torch, lambda: beam_prune.candidate_topk_cuda(logits, alive, k2=k2))
    bk, v = logits.shape
    nbytes = 4 * (bk * v + bk) + 8 * alive.shape[0] * k2
    bound_ms, bound_by = bound(nbytes, bk * v * 7)
    rec = dict(name="beam_prune", source=f"{PKG}/csrc/beam_prune.cu",
               replaces="speech_tranformer_pytorch_tpu/kernels/beam_prune.py:36",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms,
               library_note="a four-call yardstick: log_softmax, two index writes, "
                            "add, torch.topk",
               plan=beam_prune.plan(alive.shape[1], k2, logits.shape[1]),
               device_kernels_per_call=kernels_per_call, shape=[bk, v, k2])
    emit({"check": rec})
    if kernels_per_call != 1:
        raise AssertionError(f"beam_prune: {kernels_per_call} device kernels a call, not 1")
    return rec


# Lineage attention: beam 5 over the base cache [40, 100, 8, 64] at four
# indices, every beam sharing beam 0's history (after a prune that kept one
# parent), a long cache (L 256, index 200: max_decode_len and max_len_ratio
# can exceed 100) and K = 1 (greedy decoding's identity lineage).
# Tolerances as the JAX goldens (tests/test_lineage_attention_kernel.py):
# f32 2e-6 (summation order only), bf16 2e-2 (the weights are rounded to
# bf16 before the AV product). Every case must be bit-identical on a
# second call; the index is a device int32, which the kernel reads itself
# (every decode step's route). The `sharded` preset's decode in
# parallel_path runs the kernel at D 128 (16 lanes a row, not 8) with 16
# heads on one card and 4 a rank under TP 4: both are checked on its 40
# rows x L 100 at index 0, 49 and 99 and at K = 1. Timed in bf16 at index 0, 49 and 99 of the
# beam-5 cache, at K = 1 on 8 rows and at the sharded shape on one card;
# the kernels line reports the base cache at index 49.
LINEAGE_TIMED = (("beam5", 5, 100, 0, 8, 64), ("beam5", 5, 100, 49, 8, 64),
                 ("beam5", 5, 100, 99, 8, 64), ("greedy", 1, 100, 49, 8, 64),
                 ("sharded_beam5", 5, 100, 49, 16, 128))
LINEAGE_SHARDED = ((16, 128), (4, 128))      # heads, head_dim of a sharded rank


def check_lineage(torch, dev):
    from torch.nn import functional as F
    from speech_tranformer_pytorch_tpu_torch.kernels import lineage_attention as la

    b = 8
    g = torch.Generator().manual_seed(2)

    def inputs(index, dtype, k=5, L=100, shared=False, h=8, d=64):
        q = torch.randn(b * k, 1, h, d, generator=g)
        ck = torch.randn(b * k, L, h, d, generator=g)
        cv = torch.randn(b * k, L, h, d, generator=g)
        lin = torch.randint(0, k, (b, k, L), generator=g, dtype=torch.int32)
        if shared:
            lin[:] = 0
        lin[:, :, index + shared:] = torch.arange(k, dtype=torch.int32)[None, :, None]
        return [t.to(dev, dtype) for t in (q, ck, cv)] + [lin.to(dev)]

    cases = [(f"index={i}", dict(index=i)) for i in (0, 17, 49, 99)]
    cases += [("shared_history,index=49", dict(index=49, shared=True)),
              ("L=256,index=200", dict(index=200, L=256))]
    cases += [(f"K=1,index={i}", dict(index=i, k=1)) for i in (0, 31, 99)]
    cases += [(f"H={h},D={d},K={k},index={i}", dict(index=i, k=k, h=h, d=d))
              for h, d in LINEAGE_SHARDED for k in (5, 1) for i in (0, 49, 99)]
    errs, failed = {}, []
    for dtype, atol in ((torch.float32, 2e-6), (torch.bfloat16, 2e-2)):
        for label, kw in cases:
            k = kw.get("k", 5)
            args = inputs(dtype=dtype, **kw)
            index = torch.tensor(kw["index"], dtype=torch.int32, device=dev)
            got = la.lineage_attention_cuda(*args, index, k)
            again = la.lineage_attention_cuda(*args, index, k)
            want = la.lineage_attention_reference(*args, index, k)
            torch.cuda.synchronize()
            name = f"lineage_attention[{str(dtype)[6:]},{label}]"
            if got.dtype != dtype or got.shape != want.shape:
                raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}")
            same = bool(torch.equal(got, again))
            errs[(dtype, label)] = check_close(name, got, want, atol, 1e-5)
            emit({"check": {"name": name, "max_abs_err": errs[(dtype, label)],
                            "second_call_bit_equal": same}})
            if not same:
                failed.append(name)
    if failed:
        raise AssertionError(f"lineage_attention differs on a second call: {failed}")
    recs = {}
    for label, k, L, index, h, d in LINEAGE_TIMED:
        args = inputs(index, torch.bfloat16, k=k, L=L, h=h, d=d)
        q, ck, cv, lin = args
        rows = b * k
        lin_all = lin[:, :, :index + 1].long()
        src = (torch.arange(b, device=dev)[:, None, None] * k + lin_all).reshape(rows, -1)
        pos = torch.arange(index + 1, device=dev)[None, :]

        def gathered_sdpa():   # a yardstick only: not the same function (no
            kk = ck[src, pos].transpose(1, 2)   # weight rounding to bf16)
            vv = cv[src, pos].transpose(1, 2)
            return F.scaled_dot_product_attention(q.transpose(1, 2), kk, vv)

        distinct = int(torch.zeros(b, k, index + 1, device=dev).scatter_(
            1, lin_all, 1.0).sum())
        nbytes = (2 * distinct * h * d * 2          # selected K and V rows, bf16
                  + 2 * rows * h * d * 2            # q in, out
                  + rows * (index + 1) * 4)         # lineage columns read
        flops = rows * h * (index + 1) * (4 * d + 5)
        bound_ms, bound_by = bound(nbytes, flops)
        step = torch.tensor(index, dtype=torch.int32, device=dev)
        rec = dict(ms=device_ms(torch, lambda: la.lineage_attention_cuda(*args, step, k)),
                   plain_ms=device_ms(torch, lambda: la.lineage_attention_reference(
                       *args, step, k)),
                   yardstick_ms=device_ms(torch, gathered_sdpa),
                   bound_ms=bound_ms, bound_by=bound_by)
        recs[(label, index)] = rec
        emit({"check": {"name": f"lineage_timing[{label},{rows}x{L}x{h}x{d},index={index}]",
                        **rec}})
    main = recs[("beam5", 49)]
    rec = dict(name="lineage_attention", source=f"{PKG}/csrc/lineage_attention.cu",
               replaces="speech_tranformer_pytorch_tpu/kernels/lineage_attention.py:43",
               max_abs_err=max(v for (dt, _), v in errs.items() if dt == torch.bfloat16),
               max_abs_err_f32=max(v for (dt, _), v in errs.items() if dt == torch.float32),
               ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], library_ms=None, yardstick_ms=main["yardstick_ms"],
               yardstick_note="gather of the selected K/V rows + scaled_dot_product_attention "
                              "(not the same function: no bf16 rounding of the weights)",
               shape=[b * 5, 100, 8, 64, 49],
               sharded=recs[("sharded_beam5", 49)], step=check_lineage_step(torch, dev))
    emit({"check": rec})
    return rec


# The decode step's write-and-attend form (``lineage_attention_step_cuda``)
# at every served row count, beam 5, H 8, D 64: 5 rows (`base.serve.b1`),
# 40 (`base.serve.aishell-b8`), 80 (`librispeech.serve.ls-b16`) and 160
# (`conformer.serve.ls-long-b32`), each at cache lengths L from its cell's
# buckets (the calls' step budgets) and at indices 0, L // 2 and L - 1, in
# bf16 (served) and f32. q, k_new and v_new are the unbind views of one
# real qkv GEMM output [rows, 1, 3·H·D] (row stride 3·H·D), as the step
# hands them. Held bit-equal to the route it replaces (the int64 index,
# ``index_copy_`` of both rows, q made contiguous, the attend-only kernel)
# in its output and both caches; the written rows bit-equal to k_new/v_new
# and every other row untouched; within the tolerances above of the plain
# version; and bit-equal on a second call. Timed in bf16 at each cell's
# longest L, index L // 2, beside the replaced route's five kernels and
# the attend-only kernel alone.
LINEAGE_STEP_CELLS = (("base.serve.b1", 1, (6, 44)),
                      ("base.serve.aishell-b8", 8, (6, 25, 44)),
                      ("librispeech.serve.ls-b16", 16, (6, 48, 100)),
                      ("conformer.serve.ls-long-b32", 32, (48, 69, 100)))


def check_lineage_step(torch, dev):
    from torch.nn import functional as F
    from speech_tranformer_pytorch_tpu_torch.kernels import lineage_attention as la

    k, h, d, width = 5, 8, 64, 512
    g = torch.Generator().manual_seed(3)

    def inputs(b, L, index, dtype):
        rows = b * k
        x = torch.randn(rows, 1, width, generator=g).to(dev, dtype)
        w = (torch.randn(3 * h * d, width, generator=g) / width ** 0.5).to(dev, dtype)
        q, kn, vn = F.linear(x, w).unflatten(-1, (3, h, d)).unbind(-3)
        ck, cv = (torch.randn(rows, L, h, d, generator=g).to(dev, dtype) for _ in range(2))
        lin = torch.randint(0, k, (b, k, L), generator=g, dtype=torch.int32)
        lin[:, :, index:] = torch.arange(k, dtype=torch.int32)[None, :, None]
        return q, kn, vn, ck, cv, lin.to(dev)

    def replaced(q, kn, vn, ck, cv, lin, step, beams):
        pos = step.reshape(1).long()
        ck.index_copy_(1, pos, kn)
        cv.index_copy_(1, pos, vn)
        return la.lineage_attention_cuda(q, ck, cv, lin, step, beams)

    failed, errs = [], {}
    for cell, b, lengths in LINEAGE_STEP_CELLS:
        for L in lengths:
            for index in sorted({0, L // 2, L - 1}):
                for dtype, atol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-6)):
                    q, kn, vn, ck, cv, lin = inputs(b, L, index, dtype)
                    step = torch.tensor(index, dtype=torch.int32, device=dev)
                    runs = []
                    for fn in (la.lineage_attention_step_cuda, la.lineage_attention_step_cuda,
                               replaced):
                        kk, vv = ck.clone(), cv.clone()
                        runs.append((fn(q, kn, vn, kk, vv, lin, step, k), kk, vv))
                    want = la.lineage_attention_step_reference(q, kn, vn, ck.clone(), cv.clone(),
                                                               lin, step, k)
                    torch.cuda.synchronize()
                    (got, gk, gv), again, old = runs
                    name = (f"lineage_step[{str(dtype)[6:]},{cell},{b * k}x{L},"
                            f"index={index}]")
                    others = torch.arange(L, device=dev) != index
                    rec = {
                        "replaced_route_bit_equal": all(torch.equal(x, y)
                                                        for x, y in zip(runs[0], old)),
                        "second_call_bit_equal": all(torch.equal(x, y)
                                                     for x, y in zip(runs[0], again)),
                        "rows_written": bool(torch.equal(gk[:, index], kn[:, 0])
                                             and torch.equal(gv[:, index], vn[:, 0])),
                        "others_untouched": bool(torch.equal(gk[:, others], ck[:, others])
                                                 and torch.equal(gv[:, others], cv[:, others])),
                        "max_abs_err": check_close(name, got, want, atol, 1e-5)}
                    errs[(dtype, name)] = rec["max_abs_err"]
                    emit({"check": {"name": name, **rec}})
                    if not all(v for key, v in rec.items() if key != "max_abs_err"):
                        failed.append(name)
    if failed:
        raise AssertionError(f"lineage_step: {failed}")
    timed = {}
    for cell, b, lengths in LINEAGE_STEP_CELLS:
        L = lengths[-1]
        index = L // 2
        q, kn, vn, ck, cv, lin = inputs(b, L, index, torch.bfloat16)
        qc = q.contiguous()
        step = torch.tensor(index, dtype=torch.int32, device=dev)
        t = dict(
            ms=device_ms(torch, lambda: la.lineage_attention_step_cuda(
                q, kn, vn, ck, cv, lin, step, k)),
            replaced_ms=device_ms(torch, lambda: replaced(q, kn, vn, ck, cv, lin, step, k)),
            attend_only_ms=device_ms(torch, lambda: la.lineage_attention_cuda(
                qc, ck, cv, lin, step, k)))
        timed[cell] = t
        emit({"check": {"name": f"lineage_step_timing[{cell},{b * k}x{L}x{h}x{d},"
                                f"index={index}]", **t}})
    return {"max_abs_err": max(v for (dt, _), v in errs.items() if dt == torch.bfloat16),
            "max_abs_err_f32": max(v for (dt, _), v in errs.items() if dt == torch.float32),
            "cases": len(errs), "timed": timed}


# Decode cross-attention (``kernels/cross_attention.py``) at the serving
# cells' shapes: every length bucket of `base.serve.aishell-b8` (B 8) and of
# `librispeech.serve.ls-b16` (B 16), K 5, H 8, D 64, each utterance's valid
# frames drawn within its bucket; greedy decoding's K 1; a tensor-parallel
# rank's H 4 and one card's H 16 at D 128; an utterance with no valid frame
# (uniform weights over S, as the plain version's all-masked row); and the
# int8 path's dequantised cache, which keeps the encoder's frame-major
# strides. Tolerances: float32 within 1e-5 (the kernel sums up to 749 frames
# in another order, and its exp is not torch's); bfloat16 2e-2, as lineage
# attention, since a weight one ulp apart after its rounding to bf16 moves
# the output by up to a bf16 step. Every case bit-identical on a second
# call. Timed in bf16 at the LibriSpeech cell's longest padded length (S 749)
# with lengths from 749 down to 24 (its step-weighted mean, ~386) and within
# its 3000 bucket, at `base`'s 1400 bucket (S 349) and greedily there, each
# beside the plain version and the route the step ran before the kernel
# (float32 keys kept in the cache, the bias made once a step): ``library_ms``.
CROSS_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-5)}


def _cross_cases():
    """(label, B, K, H, D, S, (lo, hi): valid lengths drawn in [lo, hi] (lo 0:
    one utterance with no valid frame), frame-major) of every checked case."""
    from portbench.work.model import subsampled

    cases = []
    for cell, b, buckets in (("base", 8, MIX_BUCKETS), ("librispeech", 16, CTC_BUCKETS)):
        low = 100
        for top in buckets:
            s = subsampled(top)
            cases.append((f"{cell},S={s}", b, 5, 8, 64, s, (subsampled(low) + 1, s), False))
            low = top
    cases += [("greedy,K=1,S=349", 8, 1, 8, 64, 349, (250, 349), False),
              ("mesh_rank,H=4,D=128", 8, 5, 4, 128, 349, (250, 349), False),
              ("H=16,D=128", 8, 5, 16, 128, 349, (250, 349), False),
              ("frame_major,S=349", 8, 5, 8, 64, 349, (250, 349), True),
              ("frame_major,K=1,S=749", 16, 1, 8, 64, 749, (500, 749), True),
              ("empty_row,S=99", 8, 5, 8, 64, 99, (0, 99), False)]
    return cases


def _cross_inputs(torch, dev, dtype, g, b, k, h, d, s, lens, frame_major):
    q = torch.randn(b * k, 1, h, d, generator=g).to(dev, dtype)
    kv = []
    for _ in range(2):
        if frame_major:   # [B, S, H, D] storage seen as [B, H, S, D]
            kv.append(torch.randn(b, s, h, d, generator=g).to(dev, dtype).transpose(1, 2))
        else:
            kv.append(torch.randn(b, h, s, d, generator=g).to(dev, dtype))
    if isinstance(lens, tuple):
        lo, hi = lens
        lens = torch.randint(max(lo, 1), hi + 1, (b,), generator=g)
        if lo == 0:
            lens[b // 2] = 0
    return q, kv[0], kv[1], torch.as_tensor(lens, dtype=torch.int32).to(dev)


def check_cross_attention(torch, dev):
    from portbench.work.cross import call_counts
    from speech_tranformer_pytorch_tpu_torch.kernels import cross_attention as ca

    g = torch.Generator().manual_seed(5)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = CROSS_TOL[str(dtype)[6:]]
        for label, b, k, h, d, s, lens, frame_major in _cross_cases():
            args = _cross_inputs(torch, dev, dtype, g, b, k, h, d, s, lens, frame_major)
            got = ca.cross_attention_decode_cuda(*args)
            again = ca.cross_attention_decode_cuda(*args)
            want = ca.cross_attention_decode_reference(*args)
            torch.cuda.synchronize()
            name = f"cross_attention[{str(dtype)[6:]},{label}]"
            if got.dtype != dtype or got.shape != want.shape or got.stride() != want.stride():
                raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} {got.stride()}")
            same = bool(torch.equal(got, again))
            errs[(dtype, label)] = check_close(name, got, want, atol, rtol)
            emit({"check": {"name": name, "max_abs_err": errs[(dtype, label)],
                            "second_call_bit_equal": same,
                            "splits": ca.splits_for(b * h, s, ca._sm_count(dev.index or 0))}})
            if not same:
                raise AssertionError(f"{name}: differs on a second call")

    def old_route(q, k32, v, bias):
        bk, _, h, d = q.shape
        qb = q.reshape(k32.shape[0], -1, h, d).transpose(1, 2)
        scores = torch.einsum("bhtd,bhsd->bhts", qb.float(), k32) / math.sqrt(d)
        weights = torch.softmax(scores + bias, dim=-1).to(v.dtype)
        out = torch.einsum("bhts,bhsd->bhtd", weights, v)
        return out.transpose(1, 2).reshape(bk, 1, h * d)   # project_out's flatten

    timed = (("librispeech_mean", 16, 5, 749, torch.linspace(749, 24, 16).round().int()),
             ("librispeech_3000", 16, 5, 749, (500, 749)),
             ("base_1400", 8, 5, 349, (250, 349)),
             ("greedy_1400", 8, 1, 349, (250, 349)))
    recs = {}
    for label, b, k, s, lens in timed:
        args = _cross_inputs(torch, dev, torch.bfloat16, g, b, k, 8, 64, s, lens, False)
        q, kc, vc, lens_dev = args
        k32 = kc.float()
        valid = torch.arange(s, device=dev)[None, :] < lens_dev[:, None]
        bias = torch.where(valid, 0.0, -1e9)[:, None, None, :]
        nbytes, flops = call_counts(lens_dev.tolist(), k, 8, 64)
        bound_ms, bound_by = bound(nbytes, flops, H100_BF16_FLOP_PER_S)
        rec = dict(ms=device_ms(torch, lambda: ca.cross_attention_decode_cuda(*args)),
                   plain_ms=device_ms(torch, lambda: ca.cross_attention_decode_reference(*args)),
                   library_ms=device_ms(torch, lambda: old_route(q, k32, vc, bias)),
                   bound_ms=bound_ms, bound_by=bound_by,
                   mean_valid=float(lens_dev.float().mean()))
        recs[label] = rec
        emit({"check": {"name": f"cross_attention_timing[{label},B={b},K={k},S={s}]", **rec}})
    main = recs["librispeech_mean"]
    rec = dict(name="cross_attention_decode", source=f"{PKG}/csrc/cross_attention.cu",
               replaces="none: XLA's einsum route (speech_tranformer_pytorch_tpu/models/"
                        "modules.py:503)",
               max_abs_err=max(v for (dt, _), v in errs.items() if dt == torch.bfloat16),
               max_abs_err_f32=max(v for (dt, _), v in errs.items() if dt == torch.float32),
               ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], library_ms=main["library_ms"],
               library_note="the route before the kernel: f32 score GEMM over the kept f32 "
                            "keys, scale, bias, softmax, cast, P.V GEMM, transpose copy",
               timed=recs)
    emit({"check": rec})
    return rec


# Flash attention: the train path's three shapes (B 64, H 8, D 64; encoder
# T' 99-149, targets 11-31 of U 32), a zero-length row and ragged tiles,
# D 20 (off the 16-byte grid: the bf16 backward reads a padded copy),
# the `large` preset's 3000-frame buckets after 4x subsampling (T' 750,
# many tiles a block) and the `sharded` preset's head (D 128), causal and
# not; and large_train_path's three shapes (B 96, H 12, D 64: encoder
# self-attention at its subsampled frame counts, causal decoder
# self-attention and cross-attention at its target lengths), and the same
# three at parallel_path's `sharded` train batch on one card (B 16, H 16,
# D 128: the encoder's one ring block of its T' (741), the causal decoder
# at U 64, cross-attention 64 x 741). Tolerances: f32 as the JAX goldens (tests/test_flash_attention.py:
# 2e-3 forward, 5e-3 gradients); bf16 2e-2 of each tensor's largest value
# plus 2e-2 relative, because the bf16 kernels round p (forward and
# backward) and dS to bf16 before their tensor-core products, at other
# points of the online softmax than the plain version, and round every
# output to bf16 (a relative step of 2^-8).
FLASH_TOL = {"float32": ((2e-3, 2e-3), (5e-3, 5e-3)),
             "bfloat16": ((2e-2, 2e-2), (2e-2, 2e-2))}
TRAIN_SHAPES = ("encoder_self", "decoder_self", "cross")
LARGE_SHAPES = ("large_encoder_self", "large_decoder_self", "large_cross")
SHARDED_SHAPES = ("sharded_encoder_self", "sharded_decoder_self", "sharded_cross")


def _attention_lengths(torch, preset, batch):
    """A train batch's attention extents: (T', the encoder's subsampled
    frame counts, the target width, the target lengths)."""
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.data.features import (
        frame_lengths_from_sample_lengths, num_frames)
    from speech_tranformer_pytorch_tpu_torch.models.modules import subsampled_lengths

    fcfg = get_config(preset).features
    t = num_frames(batch.audio.shape[1], fcfg.frame_length, fcfg.frame_shift)
    frames = torch.clamp(frame_lengths_from_sample_lengths(
        batch.sample_lens, fcfg.frame_length, fcfg.frame_shift), max=t)
    t_sub = int(subsampled_lengths(torch.tensor(t)))
    return (t_sub, subsampled_lengths(frames).to(torch.int32),
            int(batch.targets_in.shape[1]), batch.target_lens.to(torch.int32))


def _flash_cases(torch):
    g = torch.Generator().manual_seed(3)
    b = 64
    enc = torch.randint(99, 150, (b,), generator=g, dtype=torch.int32)
    dec = torch.randint(11, 32, (b,), generator=g, dtype=torch.int32)
    enc[0], dec[0] = 149, 32                    # the padded widths are reached
    odd = torch.tensor([0, 77, 5], dtype=torch.int32)
    long = torch.tensor([750, 611, 402, 97], dtype=torch.int32)
    wide = torch.randint(99, 150, (8,), generator=g, dtype=torch.int32)
    wide[0] = 149
    t_enc, enc_l, t_dec, dec_l = _attention_lengths(torch, "large", _large_audio(torch))
    bl = len(enc_l)
    s_enc, senc_l, s_dec, sdec_l = _attention_lengths(torch, "sharded",
                                                      _sharded_audio(torch))
    bs = len(senc_l)
    # name, batch, Tq, Tk, kv_lengths, causal, q/k/v from one fused
    # projection, heads, head_dim
    return [("encoder_self", b, 149, 149, enc, False, True, 8, 64),
            ("decoder_self", b, 32, 32, dec, True, True, 8, 64),
            ("cross", b, 32, 149, enc, False, False, 8, 64),
            ("zero_len_ragged", 3, 70, 77, odd, False, False, 8, 64),
            ("zero_len_causal", 3, 77, 77, odd, True, True, 8, 64),
            ("narrow_head", 3, 70, 77, odd, True, False, 2, 20),   # the aligned copy
            ("long", 4, 750, 750, long, False, True, 12, 64),
            ("long_causal", 4, 750, 750, long, True, True, 12, 64),
            ("wide_head", 8, 149, 149, wide, False, True, 16, 128),
            ("wide_head_causal", 8, 149, 149, wide, True, True, 16, 128),
            ("large_encoder_self", bl, t_enc, t_enc, enc_l, False, True, 12, 64),
            ("large_decoder_self", bl, t_dec, t_dec, dec_l, True, True, 12, 64),
            ("large_cross", bl, t_dec, t_enc, enc_l, False, False, 12, 64),
            ("sharded_encoder_self", bs, s_enc, s_enc, senc_l, False, False, 16, 128),
            ("sharded_decoder_self", bs, s_dec, s_dec, sdec_l, True, True, 16, 128),
            ("sharded_cross", bs, s_dec, s_enc, senc_l, False, False, 16, 128)]


def _flash_inputs(torch, dev, dtype, b, tq, tk, fused, h, d):
    """[B, H, T, D] views of [B, T, H, D] storage (of one [B, T, 3, H, D]
    projection when ``fused``), as the model hands them over."""
    g = torch.Generator(device=dev).manual_seed(b * 1000 + tq * 10 + tk)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=g).to(dtype)
    if fused:
        q, k, v = rnd(b, tq, 3, h, d).unbind(2)
    else:
        q, k, v = rnd(b, tq, h, d), rnd(b, tk, h, d), rnd(b, tk, h, d)
    do = rnd(b, tq, h, d)
    return [x.transpose(1, 2) for x in (q, k, v, do)]


def _pairs(tq, kv_lengths, causal):
    """Kept (query, key) pairs per head: every query row, keys below the
    length (and on or below the diagonal when causal)."""
    if not causal:
        return tq * int(kv_lengths.sum())
    return sum(sum(min(t + 1, int(n)) for t in range(tq)) for n in kv_lengths)


def check_flash(torch, dev):
    from speech_tranformer_pytorch_tpu_torch.kernels import flash_attention as fa
    from torch.nn import functional as F

    per_shape = {}
    for name, b, tq, tk, lens_cpu, causal, fused, h, d in _flash_cases(torch):
        lens = lens_cpu.to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype)[6:]
            (fa_tol, fr_tol), (ga_tol, gr_tol) = FLASH_TOL[dname]
            q, k, v, do = _flash_inputs(torch, dev, dtype, b, tq, tk, fused, h, d)
            o, lse = fa.flash_fwd_cuda(q, k, v, lens, causal=causal)
            o_r, lse_r = fa.flash_fwd_reference(q, k, v, lens, causal=causal)
            di = (o_r.float() * do.float()).sum(-1)
            dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse_r, di, lens, causal=causal)
            dk_r, dv_r = fa.flash_bwd_dkv_reference(q, k, v, do, lse_r, di, lens,
                                                    causal=causal)
            dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse_r, di, lens, causal=causal)
            dq_r = fa.flash_bwd_dq_reference(q, k, v, do, lse_r, di, lens, causal=causal)
            torch.cuda.synchronize()
            tag = f"flash[{name},{dname}]"
            if o.dtype != dtype or dq.dtype != dtype or dk.dtype != dtype:
                raise AssertionError(f"{tag}: outputs not in the input dtype")
            for t in (o, lse, dq, dk, dv):
                if not bool(torch.isfinite(t).all()):
                    raise AssertionError(f"{tag}: non-finite output")
            zero = lens_cpu == 0
            if bool(zero.any()) and bool(o[zero.to(dev)].abs().max() != 0):
                raise AssertionError(f"{tag}: a zero-length row is not 0")
            errs = {"o": check_close(f"{tag}.o", o, o_r, fa_tol, fr_tol),
                    "lse": check_close(f"{tag}.lse", lse, lse_r, 1e-4, 1e-5)}
            for gname, got, want in (("dq", dq, dq_r), ("dk", dk, dk_r), ("dv", dv, dv_r)):
                scale = float(want.float().abs().max()) or 1.0
                errs[gname] = check_close(f"{tag}.{gname}", got, want,
                                          ga_tol * (scale if dname == "bfloat16" else 1.0),
                                          gr_tol)
            timed = dtype == torch.bfloat16 and name in (TRAIN_SHAPES + LARGE_SHAPES
                                                         + SHARDED_SHAPES)
            if timed:   # no atomics: a second call gives the same bits
                o2, lse2 = fa.flash_fwd_cuda(q, k, v, lens, causal=causal)
                if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                    raise AssertionError(f"{tag}: o/lse differ on a second call")
                errs["fwd_bit_identical_on_second_call"] = True
                dk2, dv2 = fa.flash_bwd_dkv_cuda(q, k, v, do, lse_r, di, lens, causal=causal)
                dq2 = fa.flash_bwd_dq_cuda(q, k, v, do, lse_r, di, lens, causal=causal)
                if not all(torch.equal(x, y) for x, y in ((dk, dk2), (dv, dv2), (dq, dq2))):
                    raise AssertionError(f"{tag}: dK/dV/dQ differ on a second call")
                errs["bwd_bit_identical_on_second_call"] = True
            emit({"check": {"name": tag, "max_abs_err": errs}})
            if not timed:
                continue
            # Timed at the train path's dtype and shapes.
            keep = fa._keep_mask(tq, tk, lens, causal)
            esz = q.element_size()
            pairs = h * _pairs(tq, lens_cpu, causal)
            io_q = b * h * tq * d * esz           # one [B, H, Tq, D] tensor
            io_k = b * h * tk * d * esz
            stat = b * h * tq * 4                 # one f32 [B, H, Tq] tensor
            qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
            o_lib = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=keep)
            # The plain versions hold [B, H, Tq, Tk] f32 tensors: fewer
            # calls at the large shapes.
            plain_ms = (lambda fn: device_ms(torch, fn, reps=3, rounds=3)
                        if name in LARGE_SHAPES + SHARDED_SHAPES else device_ms(torch, fn))
            rec = {
                "flash_fwd": dict(
                    ms=device_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, lens, causal=causal)),
                    plain_ms=plain_ms(lambda: fa.flash_fwd_reference(
                        q, k, v, lens, causal=causal)),
                    library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=keep)),
                    nbytes=2 * io_q + 2 * io_k + stat, flops=4 * d * pairs),
                "flash_bwd_dkv": dict(
                    ms=device_ms(torch, lambda: fa.flash_bwd_dkv_cuda(
                        q, k, v, do, lse_r, di, lens, causal=causal)),
                    plain_ms=plain_ms(lambda: fa.flash_bwd_dkv_reference(
                        q, k, v, do, lse_r, di, lens, causal=causal)),
                    nbytes=2 * io_q + 4 * io_k + 2 * stat, flops=8 * d * pairs),
                "flash_bwd_dq": dict(
                    ms=device_ms(torch, lambda: fa.flash_bwd_dq_cuda(
                        q, k, v, do, lse_r, di, lens, causal=causal)),
                    plain_ms=plain_ms(lambda: fa.flash_bwd_dq_reference(
                        q, k, v, do, lse_r, di, lens, causal=causal)),
                    nbytes=3 * io_q + 2 * io_k + 2 * stat, flops=6 * d * pairs),
            }
            # SDPA's autograd backward gives dq, dk and dv in one call: the
            # library time of both backward kernels together.
            lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
                o_lib, (qr, kr, vr), do, retain_graph=True))
            for kname, r in rec.items():
                r["bound_ms"], r["bound_by"] = bound(r["nbytes"], r["flops"],
                                                     H100_BF16_FLOP_PER_S)
                if kname != "flash_fwd":
                    r["library_ms"] = lib_bwd
                    r["library_covers"] = "dq+dk+dv (SDPA autograd backward)"
                r["max_abs_err"] = errs["o"] if kname == "flash_fwd" else max(
                    errs[x] for x in (("dk", "dv") if kname == "flash_bwd_dkv" else ("dq",)))
            per_shape[name] = rec
            emit({"check": {"name": f"flash_timing[{name}]", "shape": [b, h, tq, tk, d],
                            "causal": causal, **rec}})
    # The kernels line reports the base encoder self-attention shape; each
    # base train step runs every base shape 6 times. A large step runs the
    # encoder shape 12 times and the decoder shapes 6 times each, and every
    # forward twice under remat; so does a `sharded` step on one card.
    per_step = lambda kname, shapes, reps: {
        k: sum(n * per_shape[s][kname][k] for s, n in zip(shapes, reps))
        for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    recs = []
    for kname, line in (("flash_fwd", 85), ("flash_bwd_dkv", 248), ("flash_bwd_dq", 313)):
        main = per_shape["encoder_self"][kname]
        rec = dict(name=kname, source=f"{PKG}/csrc/flash_attention.cu",
                   replaces=f"speech_tranformer_pytorch_tpu/kernels/flash_attention.py:{line}",
                   max_abs_err=max(per_shape[s][kname]["max_abs_err"] for s in per_shape),
                   ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                   bound_by=main["bound_by"], library_ms=main["library_ms"],
                   shape=[64, 8, 149, 149, 64],
                   per_train_step_ms=per_step(kname, TRAIN_SHAPES, (6, 6, 6)),
                   per_large_train_step_ms=per_step(
                       kname, LARGE_SHAPES, (24, 12, 12) if kname == "flash_fwd" else (12, 6, 6)),
                   per_sharded_train_step_ms=per_step(
                       kname, SHARDED_SHAPES,
                       (24, 12, 12) if kname == "flash_fwd" else (12, 6, 6)))
        emit({"check": rec})
        recs.append(rec)
    return recs


def _bf16_ulp(torch, x):
    """The spacing of bfloat16 values at |x| (the smallest normal's at 0)."""
    x = x.float().abs().clamp(min=torch.finfo(torch.bfloat16).tiny)
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def _classic_adam_case(torch, fa, tag, params, grads, mu0, nu0, mdt, sc, hyper):
    """The classic kernel against its plain version from one start: the
    parameters within 1e-6 relative, moments of dtype ``mdt`` within one
    bf16 ulp (bf16) or 1e-6 relative (f32), and a second call from the same
    start bit-equal to the first. Returns (errors, the kernel's p, mu, nu)."""
    runs = []
    for fn in (fa.fused_adam_cuda, fa.fused_adam_cuda, fa.adam_update_reference):
        p = [x.clone() for x in params]
        mu = [x.to(mdt, copy=True) for x in mu0]
        nu = [x.to(mdt, copy=True) for x in nu0]
        fn(p, grads, mu, nu, sc, **hyper)
        runs.append((p, mu, nu))
    torch.cuda.synchronize()
    rec = {}
    for i, what in enumerate(("p", "mu", "nu")):
        worst, exact = 0.0, True
        for a, again, b in zip(*(r[i] for r in runs)):      # leaf by leaf
            a, again, b = a.float(), again.float(), b.float()
            diff = (a - b).abs()
            if mdt == torch.bfloat16 and what != "p":
                bad = diff > _bf16_ulp(torch, b)      # within one bf16 ulp
            else:
                bad = diff > 1e-6 * b.abs()           # within 1e-6 relative
            if bool(bad.any()):
                raise AssertionError(f"{tag}.{what}: {int(bad.sum())} elements off; "
                                     f"max abs err {float(diff.max())}")
            if not torch.equal(a, again):
                raise AssertionError(f"{tag}.{what}: differs on a second call")
            worst, exact = max(worst, float(diff.max())), exact and bool(torch.equal(a, b))
        rec[what] = {"max_abs_err": worst, "bit_exact": exact,
                     "second_call_bit_equal": True}
    emit({"check": {"name": tag, **rec}})
    return (rec, *runs[0])


def check_adam(torch, dev):
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.kernels import fused_adam as fa
    from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer
    from speech_tranformer_pytorch_tpu_torch.train import make_fused_opt

    cfg = get_config("base")
    with torch.device("meta"):
        shapes = [p.shape for p in SpeechTransformer(cfg.model).parameters()]
    n = sum(math.prod(s) for s in shapes)
    if n != 47_021_248:
        raise AssertionError(f"base has {n} parameters, expected 47,021,248")
    opt = make_fused_opt(cfg)
    hyper = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps, weight_decay=opt.weight_decay)
    g = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda s, std: torch.randn(s, device=dev, generator=g) * std
    params = [rnd(s, 0.05) for s in shapes]
    grads = [rnd(s, 1e-2) for s in shapes]      # global norm ~68: clip active
    mu0 = [rnd(s, 1e-3) for s in shapes]
    nu0 = [rnd(s, 1e-2).square() for s in shapes]
    count = torch.tensor(5, dtype=torch.int32, device=dev)
    timed = None
    errs = {}
    for mdt in (torch.bfloat16, torch.float32):
        for clip_active in (True, False):
            gs = grads if clip_active else [x * 1e-4 for x in grads]
            sc = opt.scalars(torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(gs))), count)
            if bool(sc[0] < 1.0) != clip_active:
                raise AssertionError(f"clip scale {float(sc[0])} for clip_active={clip_active}")
            tag = f"fused_adam[{str(mdt)[6:]},clip={'on' if clip_active else 'off'}]"
            errs[tag], p_k, mu_k, nu_k = _classic_adam_case(
                torch, fa, tag, params, gs, mu0, nu0, mdt, sc, hyper)
            if mdt == torch.bfloat16 and clip_active:
                timed = (p_k, gs, mu_k, nu_k, sc)
    p_k, gs, mu_k, nu_k, sc = timed
    ms = device_ms(torch, lambda: fa.fused_adam_cuda(p_k, gs, mu_k, nu_k, sc, **hyper))
    plain_ms = device_ms(torch, lambda: fa.adam_update_reference(
        p_k, gs, mu_k, nu_k, sc, **hyper))
    lib_params = [torch.nn.Parameter(x.clone()) for x in params]
    for p_, g_ in zip(lib_params, gs):
        p_.grad = g_
    lib = torch.optim.Adam(lib_params, lr=1e-4, betas=(opt.b1, opt.b2), eps=opt.eps,
                           fused=True)
    library_ms = device_ms(torch, lib.step)
    nbytes = 20 * n                   # g, p, mu, nu read; p, mu, nu written (bf16 moments)
    bound_ms, bound_by = bound(nbytes, 16 * n)
    master_rec, large = check_adam_master(torch, dev)
    sharded = check_adam_sharded(torch, dev)
    rec = dict(name="fused_adam", source=f"{PKG}/csrc/fused_adam.cu",
               replaces="speech_tranformer_pytorch_tpu/ops/fused_adam.py:46",
               max_abs_err=max([large["max_abs_err"]] + [
                   r["max_abs_err"] for r in sharded.values()] + [
                   r[w]["max_abs_err"] for r in errs.values() for w in r]),
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms,
               library_note="torch.optim.Adam(fused=True) on the same f32 tree; "
                            "it keeps f32 moments (28 B a parameter, not 20)",
               params=n, leaves=len(shapes), large=large, sharded=sharded)
    emit({"check": rec})
    return [rec, master_rec]


# The classic kernel on parallel_path's trees: the `sharded` preset's whole
# tree (1,021,205,888 parameters, 4 GB of f32 a tensor: the one-card run)
# and model rank 0's shards under TP 4 (the four-card run), at the
# preset's bf16 moments with the clip active, under check_adam's
# tolerances and second-call bit check; each timed beside its plain version
# and torch.optim.Adam(fused=True). Returns {"tp1": ..., "tp4": ...}.
SHARDED_PARAMS = 1_021_205_888


def check_adam_sharded(torch, dev):
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.kernels import fused_adam as fa
    from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer
    from speech_tranformer_pytorch_tpu_torch.parallel.sharding import shard_params
    from speech_tranformer_pytorch_tpu_torch.train import make_fused_opt

    cfg = get_config("sharded")
    with torch.device("meta"):
        whole = dict(SpeechTransformer(cfg.model).named_parameters())
    opt = make_fused_opt(cfg)
    hyper = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps, weight_decay=opt.weight_decay)
    mdt = getattr(torch, cfg.train.moment_dtype)
    out = {}
    for tp in (1, 4):
        shapes = [v.shape for v in shard_params(whole, tp, 0).values()]
        n = sum(math.prod(s_) for s_ in shapes)
        if tp == 1 and n != SHARDED_PARAMS:
            raise AssertionError(f"sharded has {n} parameters, expected {SHARDED_PARAMS:,}")
        g = torch.Generator(device=dev).manual_seed(7)
        rnd = lambda s_, std: torch.randn(s_, device=dev, generator=g) * std
        params = [rnd(s_, 0.02) for s_ in shapes]
        grads = [rnd(s_, 1e-2) for s_ in shapes]
        mu0 = [rnd(s_, 1e-3) for s_ in shapes]
        nu0 = [rnd(s_, 1e-2).square() for s_ in shapes]
        sc = opt.scalars(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))),
                         torch.tensor(5, dtype=torch.int32, device=dev))
        if not bool(sc[0] < 1.0):
            raise AssertionError(f"clip scale {float(sc[0])}: the clip should be active")
        errs, p_k, mu_k, nu_k = _classic_adam_case(
            torch, fa, f"fused_adam_sharded[tp={tp}]", params, grads, mu0, nu0, mdt, sc,
            hyper)
        del mu0, nu0
        lib_params = [torch.nn.Parameter(x) for x in params]
        for p_, g_ in zip(lib_params, grads):
            p_.grad = g_
        lib = torch.optim.Adam(lib_params, lr=1e-4, betas=(opt.b1, opt.b2), eps=opt.eps,
                               fused=True)
        rec = dict(ms=device_ms(torch, lambda: fa.fused_adam_cuda(
                       p_k, grads, mu_k, nu_k, sc, **hyper)),
                   plain_ms=device_ms(torch, lambda: fa.adam_update_reference(
                       p_k, grads, mu_k, nu_k, sc, **hyper), reps=3, rounds=3),
                   library_ms=device_ms(torch, lib.step, reps=5, rounds=3),
                   max_abs_err=max(r["max_abs_err"] for r in errs.values()),
                   params=n, leaves=len(shapes))
        rec["bound_ms"], rec["bound_by"] = bound(20 * n, 16 * n)
        emit({"check": {"name": f"fused_adam_timing[sharded,tp={tp}]", **rec}})
        out[f"tp{tp}"] = rec
        del params, grads, p_k, mu_k, nu_k, lib, lib_params
        torch.cuda.empty_cache()
    return out


# The master-weights variant of B-9 at the `large` tree's leaf mix: bf16
# gradients and parameters, f32 masters, bf16 and f32 moments, weight decay
# 0 and 0.01, the clip active. Master, moments and parameters must equal the
# plain version bit for bit, and a second call from the same start must
# equal the first. The classic kernel, which the `large` preset's classic
# step launches, runs beside it on the same tree (f32 parameters and
# gradients) under check_adam's tolerances. Both are timed at bf16
# moments, no weight decay (the preset's). Returns (the master variant's
# record, the classic kernel's at the `large` tree).
def check_adam_master(torch, dev):
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.kernels import fused_adam as fa
    from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer
    from speech_tranformer_pytorch_tpu_torch.train import make_fused_opt

    cfg = get_config("large", **{"train.fused_optimizer": True,
                                 "train.master_weights": True})
    with torch.device("meta"):
        shapes = [p.shape for p in SpeechTransformer(cfg.model).parameters()]
    n = sum(math.prod(s) for s in shapes)
    opt = make_fused_opt(cfg)
    g = torch.Generator(device=dev).manual_seed(6)
    rnd = lambda s, std: torch.randn(s, device=dev, generator=g) * std
    masters = [rnd(s, 0.05) for s in shapes]
    grads = [rnd(s, 1e-2).to(torch.bfloat16) for s in shapes]   # norm ~120: clip on
    mu0 = [rnd(s, 1e-3) for s in shapes]
    nu0 = [rnd(s, 1e-2).square() for s in shapes]
    sc = opt.scalars(torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([x.float() for x in grads]))), torch.tensor(
            5, dtype=torch.int32, device=dev))
    if not bool(sc[0] < 1.0):
        raise AssertionError(f"clip scale {float(sc[0])}: the clip should be active")
    cat = lambda xs: torch.cat([x.reshape(-1).float() for x in xs])
    grads32 = [x.float() for x in grads]
    timed, max_err, classic_err, classic = None, 0.0, 0.0, None
    for mdt in (torch.bfloat16, torch.float32):
        for wd in (0.0, 0.01):
            hyper = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps, weight_decay=wd)
            crec, *c_out = _classic_adam_case(
                torch, fa, f"fused_adam_large[{str(mdt)[6:]},wd={wd}]", masters, grads32,
                mu0, nu0, mdt, sc, hyper)
            classic_err = max([classic_err] + [r["max_abs_err"] for r in crec.values()])
            if mdt == torch.bfloat16 and wd == 0.0:
                classic = c_out
            del c_out
            runs = []
            for fn in (fa.fused_adam_master_cuda, fa.fused_adam_master_cuda,
                       fa.adam_update_master_reference):
                w = [x.clone() for x in masters]
                p = [x.to(torch.bfloat16) for x in masters]
                mu = [x.to(mdt, copy=True) for x in mu0]
                nu = [x.to(mdt, copy=True) for x in nu0]
                fn(p, grads, w, mu, nu, sc, **hyper)
                runs.append((p, w, mu, nu))
            torch.cuda.synchronize()
            tag = f"fused_adam_master[{str(mdt)[6:]},wd={wd}]"
            rec = {}
            for i, what in enumerate(("p", "master", "mu", "nu")):
                got, again, want = (cat(r[i]) for r in runs)
                rec[what] = {"max_abs_err": float((got - want).abs().max()),
                             "bit_exact": bool(torch.equal(got, want)),
                             "second_call_bit_equal": bool(torch.equal(got, again))}
            emit({"check": {"name": tag, **rec}})
            max_err = max([max_err] + [r["max_abs_err"] for r in rec.values()])
            bad = [w for w, r in rec.items()
                   if not (r["bit_exact"] and r["second_call_bit_equal"])]
            if bad:
                raise AssertionError(f"{tag}: {bad} differ from the plain version or "
                                     f"between calls: {rec}")
            if mdt == torch.bfloat16 and wd == 0.0:
                timed = runs[0], hyper
    (p, w, mu, nu), hyper = timed
    ms = device_ms(torch, lambda: fa.fused_adam_master_cuda(p, grads, w, mu, nu, sc, **hyper))
    plain_ms = device_ms(torch, lambda: fa.adam_update_master_reference(
        p, grads, w, mu, nu, sc, **hyper), reps=3, rounds=3)
    cp, cmu, cnu = classic
    lib_params = [torch.nn.Parameter(x.clone()) for x in masters]
    for p_, g_ in zip(lib_params, grads32):
        p_.grad = g_
    lib = torch.optim.Adam(lib_params, lr=1e-4, betas=(opt.b1, opt.b2), eps=opt.eps,
                           fused=True)
    large = dict(ms=device_ms(torch, lambda: fa.fused_adam_cuda(
                     cp, grads32, cmu, cnu, sc, **hyper)),
                 plain_ms=device_ms(torch, lambda: fa.adam_update_reference(
                     cp, grads32, cmu, cnu, sc, **hyper), reps=3, rounds=3),
                 library_ms=device_ms(torch, lib.step),
                 max_abs_err=classic_err, params=n, leaves=len(shapes))
    large["bound_ms"], large["bound_by"] = bound(20 * n, 16 * n)
    emit({"check": {"name": "fused_adam_timing[large]", **large}})
    del lib, lib_params, classic, cp, cmu, cnu
    # g 2, master 4 + 4, mu 2 + 2, nu 2 + 2, p 2 bytes a parameter; 16 f32
    # operations (the classic row's count; the two casts are free).
    bound_ms, bound_by = bound(20 * n, 16 * n)
    rec = dict(name="fused_adam_master", source=f"{PKG}/csrc/fused_adam.cu",
               replaces="speech_tranformer_pytorch_tpu/ops/fused_adam.py:46",
               replaces_note="the master variant of B-9: JAX's updm "
                             "(ops/fused_adam.py:199-210), which the TPU runs "
                             "through XLA beside the Pallas kernel",
               max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None,
               library_note="no PyTorch call updates an f32 master from bf16 "
                            "gradients and writes bf16 parameters",
               params=n, leaves=len(shapes))
    emit({"check": rec})
    return rec, large


def _int8_operands(torch, dev, g, m, k, n, dtype):
    x = torch.randn(m, k, generator=g).to(dev, dtype)
    wq = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8).to(dev)
    scale = (torch.rand(n, generator=g) * 0.019 + 0.001).to(dev)
    return x, wq, scale


def _row_rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    rowmax = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    return float(((got - want).abs() / rowmax).max())


# Int8 matmul: the base decode shapes (B·K = 40 rows at beam 5, 8 greedy)
# of the self qkv (n 1536) and the q / out projections (n 512), the cross
# K/V projections of init_cache (B·S = 1192 rows), the same for
# ``manifest_path``'s batches of 4 (20 rows at beam 5, init_cache 4·149 =
# 596 rows), a wide layer, a single row and a ragged one. Tolerances: f32 within 1e-5 of each row's largest
# value (summation order only); bf16 within one bf16 ulp of the plain
# version's value (the same f32 value, rounded once to bf16) plus the same
# 1e-5 of the row's largest value (outputs near 0 come from cancelling
# sums, whose order-dependent f32 error exceeds their own ulp). Two calls
# on the same inputs must be bit-equal (the split-k partials are summed in
# a fixed order). The first four bf16 shapes and init_cache's are timed;
# the kernels line reports the first.
INT8_MATMUL_SHAPES = [(40, 512, 1536), (40, 512, 512), (8, 512, 1536), (8, 512, 512),
                      (1192, 512, 512), (20, 512, 1536), (20, 512, 512), (596, 512, 512),
                      (48, 2048, 6144), (1, 512, 512), (7, 96, 200)]
INT8_MATMUL_TIMED = [(40, 512, 1536), (40, 512, 512), (8, 512, 1536), (1192, 512, 512)]


def check_int8_matmul(torch, dev):
    from torch.nn import functional as F
    from speech_tranformer_pytorch_tpu_torch.kernels import int8_matmul as mm

    g = torch.Generator().manual_seed(6)
    errs, timed, failed = {}, {}, []
    for m, k, n in INT8_MATMUL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x, wq, scale = _int8_operands(torch, dev, g, m, k, n, dtype)
            got = mm.int8_matmul_cuda(x, wq, scale)
            again = mm.int8_matmul_cuda(x, wq, scale)
            want = mm.int8_matmul_reference(x, wq, scale)
            torch.cuda.synchronize()
            tag = f"int8_matmul[{m}x{k}x{n},{str(dtype)[6:]}]"
            if got.dtype != dtype or got.shape != (m, n):
                raise AssertionError(f"{tag}: {got.dtype} {tuple(got.shape)}")
            same = bool(torch.equal(got, again))
            if dtype == torch.bfloat16:
                diff = (got.float() - want.float()).abs()
                rowmax = want.float().abs().amax(dim=1, keepdim=True)
                bad = diff > _bf16_ulp(torch, want) + 1e-5 * rowmax
                err = float(diff.max())
            else:
                err = _row_rel_err(got, want)
                bad = torch.tensor(err > 1e-5)
            errs[tag] = err
            emit({"check": {"name": tag, "max_err": err, "n_bad": int(bad.sum()),
                            "err_is": "abs" if dtype == torch.bfloat16 else "of row max",
                            "second_call_bit_equal": same}})
            if bool(bad.any()) or not same:
                failed.append(tag)
            if (m, k, n) in INT8_MATMUL_TIMED and dtype == torch.bfloat16:
                timed[(m, k, n)] = (x, wq, scale)
    if failed:
        raise AssertionError(f"int8_matmul outside its tolerance or not deterministic: "
                             f"{failed}")
    recs = {}
    for (m, k, n), (x, wq, scale) in timed.items():
        w_deq = (wq.to(torch.bfloat16) * scale.to(torch.bfloat16)[None, :]).t().contiguous()
        nbytes = 2 * m * k + k * n + 4 * n + 2 * m * n
        bound_ms, bound_by = bound(nbytes, 2 * m * k * n, H100_BF16_FLOP_PER_S)
        rows, k_chunk = mm.plan(m, k, n)
        recs[(m, k, n)] = dict(
            ms=device_ms(torch, lambda: mm.int8_matmul_cuda(x, wq, scale)),
            plain_ms=device_ms(torch, lambda: mm.int8_matmul_reference(x, wq, scale)),
            library_ms=device_ms(torch, lambda: F.linear(x, w_deq)),
            bound_ms=bound_ms, bound_by=bound_by,
            plan={"rows": rows, "k_chunk": k_chunk, "blocks": -(-n // mm.BLOCK_COLS)
                  * -(-m // rows) * -(-k // k_chunk)})
        emit({"check": {"name": f"int8_matmul_timing[{m}x{k}x{n}]", **recs[(m, k, n)]}})
    main = recs[INT8_MATMUL_TIMED[0]]
    rec = dict(name="int8_matmul", source=f"{PKG}/csrc/int8_matmul.cu",
               replaces="speech_tranformer_pytorch_tpu/kernels/int8_matmul.py:52",
               max_abs_err=max(v for t, v in errs.items() if "bfloat16" in t),
               max_err_f32_of_row_max=max(v for t, v in errs.items() if "float32" in t),
               ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], library_ms=main["library_ms"],
               library_note="F.linear on the weight dequantized to bf16 (rounds w*s "
                            "to bf16 before the product; reads 2 B a weight)",
               shape=list(INT8_MATMUL_TIMED[0]))
    emit({"check": rec})
    return rec


# Fused int8 feed-forward: the base decode shapes (B·K = 40, greedy 8, and
# ``manifest_path``'s 20 at beam 5), the `large` preset's (d_model 768,
# d_ff 3072), more than 64 rows (three row tiles) and a ragged one.
# Tolerances: f32 within 1e-5 of each row's
# largest value; bf16 within 1e-3 of it (the JAX kernel's bound: the hidden
# layer is rounded to bf16 after differently ordered sums) plus one bf16
# ulp of the output. Two calls on the same inputs must be bit-equal. The
# two base decode shapes are timed; the kernels line reports the first.
INT8_FFN_SHAPES = [(40, 512, 2048, 512), (8, 512, 2048, 512), (20, 512, 2048, 512),
                   (40, 768, 3072, 768), (130, 512, 2048, 512), (7, 96, 200, 72)]
INT8_FFN_TIMED = [(40, 512, 2048, 512), (8, 512, 2048, 512)]


def check_int8_ffn(torch, dev):
    from torch.nn import functional as F
    from speech_tranformer_pytorch_tpu_torch.kernels import int8_ffn as ffn

    g = torch.Generator().manual_seed(7)
    errs, abs_errs, timed, failed = {}, {}, {}, []
    for m, k, ff, n in INT8_FFN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x, w1, s1 = _int8_operands(torch, dev, g, m, k, ff, dtype)
            _, w2, s2 = _int8_operands(torch, dev, g, 1, ff, n, dtype)
            b1 = (torch.randn(ff, generator=g) * 0.1).to(dev)
            b2 = (torch.randn(n, generator=g) * 0.1).to(dev)
            args = (x, w1, s1, b1, w2, s2, b2)
            got = ffn.int8_ffn_cuda(*args)
            again = ffn.int8_ffn_cuda(*args)
            want = ffn.int8_ffn_reference(*args)
            torch.cuda.synchronize()
            tag = f"int8_ffn[{m}x{k}x{ff}x{n},{str(dtype)[6:]}]"
            if got.dtype != dtype or got.shape != (m, n):
                raise AssertionError(f"{tag}: {got.dtype} {tuple(got.shape)}")
            same = bool(torch.equal(got, again))
            err = _row_rel_err(got, want)
            if dtype == torch.bfloat16:
                rowmax = want.float().abs().amax(dim=1, keepdim=True)
                bad = (got.float() - want.float()).abs() > 1e-3 * rowmax + _bf16_ulp(torch, want)
            else:
                bad = torch.tensor(err > 1e-5)
            errs[tag] = err
            abs_errs[tag] = float((got.float() - want.float()).abs().max())
            emit({"check": {"name": tag, "max_err_of_row_max": err, "n_bad": int(bad.sum()),
                            "max_abs_err": abs_errs[tag], "second_call_bit_equal": same}})
            if bool(bad.any()) or not same:
                failed.append(tag)
            if (m, k, ff, n) in INT8_FFN_TIMED and dtype == torch.bfloat16:
                timed[(m, k, ff, n)] = args
    if failed:
        raise AssertionError(f"int8_ffn outside its tolerance or not deterministic: {failed}")
    recs = {}
    for (m, k, ff, n), args in timed.items():
        x, w1, s1, b1, w2, s2, b2 = args
        d1 = (w1.to(torch.bfloat16) * s1.to(torch.bfloat16)[None, :]).t().contiguous()
        d2 = (w2.to(torch.bfloat16) * s2.to(torch.bfloat16)[None, :]).t().contiguous()
        bb1, bb2 = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
        nbytes = 2 * m * k + k * ff + ff * n + 8 * ff + 8 * n + 2 * m * n
        bound_ms, bound_by = bound(nbytes, 2 * m * ff * (k + n), H100_BF16_FLOP_PER_S)
        rows, tiles, ranks, col_tiles = ffn.plan(m, k, ff, n)
        recs[(m, k, ff, n)] = dict(
            ms=device_ms(torch, lambda: ffn.int8_ffn_cuda(*args)),
            plain_ms=device_ms(torch, lambda: ffn.int8_ffn_reference(*args)),
            yardstick_ms=device_ms(torch, lambda: F.linear(F.relu(F.linear(x, d1, bb1)),
                                                           d2, bb2)),
            bound_ms=bound_ms, bound_by=bound_by,
            plan={"rows": rows, "hidden_tiles": tiles, "ranks": ranks, "col_tiles": col_tiles,
                  "blocks": -(-n // (ffn.BLOCK_COLS * col_tiles)) * -(-m // rows) * ranks})
        emit({"check": {"name": f"int8_ffn_timing[{m}x{k}x{ff}x{n}]", **recs[(m, k, ff, n)]}})
    main = recs[INT8_FFN_TIMED[0]]
    rec = dict(name="int8_ffn", source=f"{PKG}/csrc/int8_ffn.cu",
               replaces="speech_tranformer_pytorch_tpu/kernels/int8_ffn.py:50",
               max_abs_err=max(abs_errs.values()), max_err_of_row_max=max(errs.values()),
               deterministic=True, ms=main["ms"], plain_ms=main["plain_ms"],
               bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=None,
               yardstick_ms=main["yardstick_ms"],
               yardstick_note="F.linear + relu + F.linear on bf16-dequantized weights "
                              "(three calls; no single PyTorch call fuses them)",
               shape=list(INT8_FFN_TIMED[0]))
    emit({"check": rec})
    return rec


def step_launches(cfg, master: bool, ring: int = 1):
    """Exact kernel launches of one train step: one fbank; per attention
    layer (encoder self, decoder self and cross) a flash forward, run again
    in the backward's recompute under remat, one dK/dV and one dQ (an
    encoder layer on a ring of ``ring`` ranks: one of each per key block);
    one Adam launch, of the master variant with master weights."""
    from speech_tranformer_pytorch_tpu_torch.kernels import interface

    m = cfg.model
    layers = m.num_encoder_layers * ring + 2 * m.num_decoder_layers
    want = {k: 0 for k in interface.launch_counts()}
    want.update(stft_mel=1, flash_fwd=layers * (2 if m.remat else 1),
                flash_bwd_dkv=layers, flash_bwd_dq=layers)
    want["fused_adam_master" if master else "fused_adam"] = 1
    return want


def train_path(torch, dev):
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.profile_train import (
        TIMED_STEPS, WARMUP_STEPS, smoke_train_batch)

    smoke = smoke_train_batch(dev)
    state, batch, step, cfg = smoke.state, smoke.batch, smoke.step, smoke.cfg
    want = step_launches(cfg, master=False)
    if want["flash_fwd"] != 18:
        raise AssertionError(f"{want['flash_fwd']} attention layers, not 18")
    before = {k: p.detach().clone() for k, p in state.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    interface.reset_launch_counts()
    state, walls, losses, m, norms = _checked_steps(
        torch, step, state, batch, WARMUP_STEPS + TIMED_STEPS, want, "train")
    counts = interface.launch_counts()
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss {losses} or grad_norm {norms}")
    changed = {k: float((p.detach() != before[k]).float().mean())
               for k, p in state.params.items()}
    unchanged = [k for k, f in changed.items() if f == 0.0]
    if unchanged:
        raise AssertionError(f"parameters that did not change: {unchanged}")
    timed = walls[WARMUP_STEPS:]
    wall = statistics.median(timed)
    emit({"train_path": {
        "preset": "base", "dtype": cfg.model.dtype, "moment_dtype": cfg.train.moment_dtype,
        "dropout": cfg.model.dropout_rate, "utterances": int(batch.audio.shape[0]),
        "target_width": int(batch.targets_in.shape[1]),
        "steps": len(walls), "step_wall_s_median": wall, "step_wall_s": timed,
        "audio_s_per_step": float(m["audio_seconds"]),
        "audio_s_per_s": float(m["audio_seconds"]) / wall,
        "target_tokens_per_s": float(m["tokens"]) / wall,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "loss": losses, "grad_norm": norms,
        "min_changed_fraction": min(changed.values()),
        "launches_per_step": want, "launches": counts}})
    return counts


# The `large` preset's train path: full width and depth (d_model 768, 12
# heads, d_ff 3072, 12+6 layers), bf16 over f32 masters, bf16 moments,
# dropout 0.1, SpecAugment and layer remat as the preset sets them, on
# train.batch_size (96) int16 utterances of 20-30 s (the preset's top
# bucket: up to 2,998 frames, T' 749) with 20-60 target tokens.
LARGE_SECONDS, LARGE_TOKENS = (20.0, 30.0), (20, 60)
LARGE_SHAPE = (768, 12, 3072, 12, 6, 96)   # d_model, heads, d_ff, layers, batch
MASTER_WEIGHTS = {"train.fused_optimizer": True, "train.master_weights": True}


@functools.lru_cache(maxsize=1)
def _large_audio(torch):
    """``large_train_path``'s batch, on the CPU (made once a run)."""
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.profile_train import smoke_audio_batch

    cfg = get_config("large")
    return smoke_audio_batch(cfg, cfg.train.batch_size, device=torch.device("cpu"),
                             seconds=LARGE_SECONDS, tokens=LARGE_TOKENS)


@functools.lru_cache(maxsize=1)
def _sharded_audio(torch):
    """``parallel_path``'s `sharded` train batch of one data rank, on the
    CPU."""
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.profile_train import smoke_audio_batch

    return smoke_audio_batch(get_config("sharded"), PARALLEL_UTTS, device=torch.device("cpu"),
                             seconds=PARALLEL_SECONDS, tokens=PARALLEL_TOKENS)


def _checked_steps(torch, step, state, batch, n, want, tag):
    """``n`` steps, each with exactly ``want`` launches; returns (state,
    walls, losses, metrics of the last step, grad norms)."""
    from speech_tranformer_pytorch_tpu_torch.kernels import interface

    walls, losses, norms = [], [], []
    prev = interface.launch_counts()
    for i in range(n):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        now = interface.launch_counts()
        per_step = {k: now[k] - prev[k] for k in now}
        if per_step != want:
            raise AssertionError(f"{tag} step {i}: launches {per_step}, expected {want}")
        prev = now
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, walls, losses, m, norms


def _profiled_step(torch, step, state, batch):
    """One step under torch.profiler: (state, device events, busy s, wall s)."""
    from torch.profiler import ProfilerActivity, profile

    from speech_tranformer_pytorch_tpu_torch.utils.profiling import device_ops

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, busy = device_ops(prof)
    return state, len(kernels), busy / 1e6, wall


def large_train_path(torch, dev):
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.data.augment import (
        apply_masks, draw_spec_augment, spec_augment_masks)
    from speech_tranformer_pytorch_tpu_torch.data.pipeline import (
        make_audio_train_step, make_preprocess_fn)
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.ops.dropout import (
        AUGMENT_STREAM, step_generator)
    from speech_tranformer_pytorch_tpu_torch.ops.masks import length_mask
    from speech_tranformer_pytorch_tpu_torch.profile_train import (
        TIMED_STEPS, WARMUP_STEPS, smoke_train_batch)
    from speech_tranformer_pytorch_tpu_torch.train import create_train_state, loss_and_grads

    smoke = smoke_train_batch(dev, "large", seconds=LARGE_SECONDS, tokens=LARGE_TOKENS)
    cfg, state, batch, step = smoke.cfg, smoke.state, smoke.batch, smoke.step
    del smoke
    m, sa = cfg.model, cfg.spec_augment
    shape = (m.d_model, m.num_heads, m.d_ff, m.num_encoder_layers, m.num_decoder_layers,
             cfg.train.batch_size)
    if shape != LARGE_SHAPE or not (m.remat and sa.enabled) or m.dropout_rate != 0.1:
        raise AssertionError(f"the large preset changed: {cfg.to_dict()}")
    n_params = sum(p.numel() for p in state.params.values())
    init = {k: p.detach().clone() for k, p in state.params.items()}
    seed = cfg.train.seed
    report = {"preset": "large", "params": n_params, "utterances": int(batch.audio.shape[0]),
              "samples": int(batch.audio.shape[1]),
              "target_width": int(batch.targets_in.shape[1])}

    # (b) Step 0's features: the train step's own preprocess with its own
    # augmentation generator, against the masks rebuilt from that
    # generator's draws; then the budgets on every utterance.
    pre = make_preprocess_fn(cfg.features, sa)
    plain = pre(batch, dev)
    aug = pre(batch, dev, step_generator(seed, 0, dev, AUGMENT_STREAM))
    b, t, f = plain.feats.shape
    fkeep, tkeep = spec_augment_masks(
        draw_spec_augment(step_generator(seed, 0, dev, AUGMENT_STREAM), b, t, f, sa),
        plain.frame_lens, t, f, sa)
    n = plain.frame_lens
    masked = ((~tkeep) & length_mask(n, t)).sum(1)
    frame_share, bin_share = masked / n, (~fkeep).sum(1) / f
    spec = {"frames": t, "frame_lens": [int(n.min()), int(n.max())],
            "masked_frame_share_max": float(frame_share.max()),
            "masked_frame_share_mean": float(frame_share.mean()),
            "masked_bin_share_max": float(bin_share.max()),
            "masked_frames_min": int(masked.min()), "max_total_frac": sa.max_total_frac,
            "equals_masks_of_draws": bool(torch.equal(aug.feats, apply_masks(
                plain.feats, fkeep, tkeep))),
            "changed": bool((aug.feats != plain.feats).any())}
    report["spec_augment_step0"] = spec
    if not (spec["equals_masks_of_draws"] and spec["changed"]
            and spec["masked_frame_share_max"] <= sa.max_total_frac
            and spec["masked_bin_share_max"] <= sa.max_total_frac
            and spec["masked_frames_min"] >= 1):
        raise AssertionError(f"SpecAugment at step 0: {spec}")

    # The main path: 3 warm-up and 10 timed steps, exact launches a step.
    want = step_launches(cfg, master=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    interface.reset_launch_counts()
    state, walls, losses, met, _ = _checked_steps(torch, step, state, batch,
                                                  WARMUP_STEPS + TIMED_STEPS, want, "large")
    counts = interface.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    unchanged = [k for k, p in state.params.items() if torch.equal(p.detach(), init[k])]
    if unchanged or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}; parameters that did not change: {unchanged}")
    timed = walls[WARMUP_STEPS:]
    wall = statistics.median(timed)
    audio_s = float(met["audio_seconds"])
    report.update({
        "steps": len(walls), "step_wall_s_median": wall, "step_wall_s": timed,
        "step_wall_s_spread": [min(timed), max(timed)], "audio_s_per_step": audio_s,
        "audio_s_per_s": audio_s / wall, "target_tokens_per_s": float(met["tokens"]) / wall,
        "peak_mem_bytes": peak, "loss": losses, "launches_per_step": want})
    del state

    # (a) Remat is exact: one step's loss and gradients with remat on and
    # off, from the same weights, batch (step 0's augmented features) and
    # dropout seed. Called twice each; the second call is timed.
    runs = {}
    for remat in (True, False):
        c = cfg.replace(model=m.replace(remat=remat))
        st = create_train_state(c, device=dev, params=init)
        for _ in range(2):
            runs.pop(remat, None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            grads, mm = loss_and_grads(c, st, aug, seed)
            torch.cuda.synchronize()
            runs[remat] = (grads, mm["loss"], time.perf_counter() - t0,
                           torch.cuda.max_memory_allocated(dev) - base)
        del st
    (g_on, loss_on, t_on, mem_on), (g_off, loss_off, t_off, mem_off) = runs[True], runs[False]
    err = {k: float((g_on[k].float() - g_off[k].float()).abs().max())
           / max(float(g_off[k].abs().max()), 1e-30) for k in g_off}
    remat_rep = {"loss_bit_equal": bool(torch.equal(loss_on, loss_off)),
                 "loss": float(loss_on), "grad_err_over_leaf_max": max(err.values()),
                 "leaves_not_bit_equal": [k for k in g_off if not torch.equal(g_on[k], g_off[k])],
                 "leaves": len(g_off), "loss_and_grads_s": {"remat": t_on, "no_remat": t_off},
                 "peak_mem_above_state_bytes": {"remat": mem_on, "no_remat": mem_off}}
    report["remat_exact"] = remat_rep
    del runs, g_on, g_off
    if not remat_rep["loss_bit_equal"] or remat_rep["grad_err_over_leaf_max"] > 1e-5:
        raise AssertionError(f"remat changes the step: {remat_rep}")

    # (c) Master weights are exact: 3 steps from the same start with the
    # classic scheme and with master weights (fused optimizer); the f32
    # master must equal the classic f32 parameters bit for bit. Then one
    # profiled step of each: device events and busy time a step.
    cm = get_config("large", **MASTER_WEIGHTS)
    out, master_counts = {}, {}
    for name, c in (("classic", cfg), ("master", cm)):
        st = create_train_state(c, device=dev, params=init)
        stp = make_audio_train_step(c)
        w = step_launches(c, master=name == "master")
        interface.reset_launch_counts()
        st, walls_c, losses_c, _, _ = _checked_steps(torch, stp, st, batch, 3, w, name)
        if name == "master":
            master_counts = interface.launch_counts()
        f32 = st.opt.master if name == "master" else st.params
        f32 = {k: v.detach().clone() for k, v in f32.items()}
        bf16 = {k: v.detach().to(torch.bfloat16, copy=True) for k, v in st.params.items()}
        st, events, busy, wall_p = _profiled_step(torch, stp, st, batch)
        out[name] = dict(f32=f32, bf16=bf16, losses=losses_c, walls=walls_c, events=events,
                         busy_s=busy, wall_s=wall_p, param_dtype=str(next(
                             iter(st.params.values())).dtype))
        del st
    cl, ms_ = out["classic"], out["master"]
    master_rep = {
        "master_bit_equal_classic_f32": all(torch.equal(ms_["f32"][k], cl["f32"][k])
                                            for k in cl["f32"]),
        "params_bit_equal_classic_cast": all(torch.equal(ms_["bf16"][k], cl["bf16"][k])
                                             for k in cl["bf16"]),
        "losses": {"classic": cl["losses"], "master": ms_["losses"]},
        "param_dtype": {"classic": cl["param_dtype"], "master": ms_["param_dtype"]},
        "step_wall_s": {"classic": cl["walls"], "master": ms_["walls"]},
        "device_events_per_step": {"classic": cl["events"], "master": ms_["events"]},
        "device_busy_s": {"classic": cl["busy_s"], "master": ms_["busy_s"]},
        "device_idle_share": {k: 1.0 - out[k]["busy_s"] / out[k]["wall_s"] for k in out},
        "launches_per_step": step_launches(cm, master=True)}
    report["master_weights"] = master_rep
    report["device_busy_s"] = cl["busy_s"]
    report["device_idle_share"] = master_rep["device_idle_share"]["classic"]
    if not (master_rep["master_bit_equal_classic_f32"]
            and master_rep["params_bit_equal_classic_cast"]
            and cl["losses"] == ms_["losses"]):
        emit({"large_train_path": report})
        raise AssertionError(f"master weights differ from the classic scheme: {master_rep}")
    del out, cl, ms_
    paths = {"large": counts, "large_master": master_counts}
    report["trainer"], trainer_counts = _presets_trainer(torch, dev)
    paths.update(trainer_counts)
    report["launches_by_path"] = paths
    report["card"] = smi_line()
    emit({"large_train_path": report})
    return paths


def _presets_trainer(torch, dev):
    """(d) The ``large`` preset with master weights and the ``librispeech``
    preset, at full width and depth, through the ``Trainer`` on a WAV
    manifest (batch 8 of 4-6 s): 2 steps each with exact launches, then
    ``load_recognizer`` serves the last checkpoint (the master-weights one
    for ``large``) and decodes 2 utterances greedily. Returns (the report,
    the launches of each run: ``large_trainer`` and ``librispeech``)."""
    import tempfile

    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.recognize import load_recognizer
    from speech_tranformer_pytorch_tpu_torch.runner import Trainer

    report, counts = {}, {}
    small = {"train.batch_size": 8, "train.num_epochs": 100, "train.log_every": 1,
             "train.checkpoint_every_steps": 100}
    with tempfile.TemporaryDirectory() as tmp:
        presets = (("large", MASTER_WEIGHTS), ("librispeech", {}))
        paths = _write_corpus(tmp, min(get_config(p).model.vocab_size for p, _ in presets))
        for preset, over in presets:
            cfg = get_config(preset, **small, **over)
            work = f"{tmp}/{preset}"
            tr = Trainer(cfg, work_dir=work, train_manifest=paths["train"], device=dev)
            interface.reset_launch_counts()
            t0 = time.perf_counter()
            state = tr.train(max_steps=2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = interface.launch_counts()
            one = step_launches(cfg, master=cfg.train.master_weights)
            want = {k: 2 * v for k, v in one.items()}
            counts["large_trainer" if preset == "large" else preset] = got
            rec = load_recognizer(cfg, f"{work}/checkpoints", device=dev)
            served = dict(rec.model.named_parameters())
            same = all(torch.equal(served[k], p.detach().to(served[k].dtype))
                       for k, p in state.params.items())
            batch = tr.batcher._make_batch([0, 1], 3)      # the 800-frame bucket
            hyps = rec.decode_batch(batch.audio, batch.sample_lens, beam_size=1,
                                    max_len=4, alpha=1.0)
            report[preset] = {"overrides": dict(small, **over), "steps": state.step,
                              "wall_s": wall, "launches": got, "launches_expected": want,
                              "param_dtype": str(next(iter(state.params.values())).dtype),
                              "served_params_equal": same, "greedy_hyps": hyps}
            if got != want or not same or state.step != 2 or len(hyps) != 2:
                raise AssertionError(f"{preset} through the Trainer: {report[preset]}")
            del tr, state, rec, served
    return report, counts


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return smi.strip().splitlines()[0]


def train_card_vs_cpu(torch, dev):
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.data.pipeline import make_preprocess_fn
    from speech_tranformer_pytorch_tpu_torch.profile_train import smoke_audio_batch
    from speech_tranformer_pytorch_tpu_torch.train import (
        create_train_state, loss_and_grads, make_train_step)

    # One float32 step (f32 compute and moments, dropout off) from the same
    # weights and the same features (made once by the card's fbank kernel:
    # check_fbank holds that kernel to its plain version at 1e-3, a gap the
    # log and CMVN would carry into every gradient).
    # A ReLU input within rounding of 0 may take opposite signs on the two
    # devices; such a flip adds or drops one hidden unit's whole gradient
    # term, in its fc1 leaves and, through the layer's input, in every leaf
    # below. So the CPU runs first, and on the card a forward hook gives
    # each flipped fc1 output the CPU's value (its gradient path kept):
    # both sides then take the same ReLU branches. Every flip is counted
    # and must lie within 1e-5 of the layer's largest |pre-activation| on
    # both devices; a larger one is a real difference and fails.
    # Tolerances: loss and grad norm 1e-4 relative; each gradient leaf
    # within 1e-4 of its largest value, except the key-projection biases of
    # cross-attention, whose exact gradient is zero (softmax ignores a shift
    # shared by all keys) and whose computed one is rounding noise: they
    # are held to 1e-4 of the largest gradient of all leaves.
    # Params within 2·lr plus one f32 ulp of the parameter: the first Adam
    # step moves an element by lr·m̂/(√v̂ + eps) ≈ ±lr, so an element whose
    # gradient is noise may flip sign, and each side rounds p - lr·u.
    cfg = get_config("base", **{"model.dtype": "float32", "model.dropout_rate": 0.0,
                                "features.output_dtype": "float32",
                                "train.moment_dtype": "float32"})
    cpu = torch.device("cpu")
    abatch = smoke_audio_batch(cfg, 2, seed=7, device=cpu)
    params = create_train_state(cfg, device=cpu, seed=1).model.state_dict()
    preprocess = make_preprocess_fn(cfg.features)
    step = make_train_step(cfg)
    features = preprocess(abatch.to(dev), dev)
    relu_cpu, flips = {}, {}

    def capture(_m, _i, y, name):
        relu_cpu[name] = y.detach().clone()

    def align(_m, _i, y, name):
        ref = relu_cpu[name].to(y.device)
        flip = (y > 0) != (ref > 0)
        if bool(flip.any()):
            size = torch.maximum(y.detach().abs(), ref.abs())[flip]
            flips[name] = (int(flip.sum()), float(size.max() / ref.abs().max()))
        return torch.where(flip, y + (ref - y).detach(), y)

    out = []
    for where, hook in ((cpu, capture), (dev, align)):
        state = create_train_state(cfg, device=where, params=params)
        batch = features.to(where)
        hooks = [mod.register_forward_hook(
            lambda m, i, y, name=name, hook=hook: hook(m, i, y, name))
            for name, mod in state.model.named_modules() if name.endswith("ffn.fc1")]
        grads, _ = loss_and_grads(cfg, state, batch, cfg.train.seed)
        state, m = step(state, batch)
        for h in hooks:
            h.remove()
        out.append(({k: float(v) for k, v in m.items()},
                    {k: g.cpu() for k, g in grads.items()},
                    {k: p.detach().cpu() for k, p in state.params.items()}))
    (m_c, g_c, p_c), (m_g, g_g, p_g) = out
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    top = max(float(g.abs().max()) for g in g_c.values())
    scale = lambda k: (top if k.endswith("cross_attn.k.bias")
                       else max(float(g_c[k].abs().max()), 1e-30))
    grad_err = {k: float((g_g[k] - g_c[k]).abs().max()) / scale(k) for k in g_c}
    grad_bad = {k: e for k, e in grad_err.items() if e > 1e-4}
    flips_bad = {k: v for k, v in flips.items() if v[1] > 1e-5}
    ulp = torch.finfo(torch.float32).eps
    param_over = {k: float(((p_g[k] - p_c[k]).abs()
                            - (2 * m_c["lr"] + ulp * p_c[k].abs())).max()) for k in p_c}
    param_err = {k: float((p_g[k] - p_c[k]).abs().max()) for k in p_c}
    worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:4]
    res = {"loss": [m_g["loss"], m_c["loss"]], "grad_norm": [m_g["grad_norm"], m_c["grad_norm"]],
           "loss_rel_err": rel(m_g["loss"], m_c["loss"]),
           "grad_norm_rel_err": rel(m_g["grad_norm"], m_c["grad_norm"]),
           "grad_err_over_leaf_max": max(grad_err.values()),
           "param_max_abs_err": max(param_err.values()), "lr": m_c["lr"],
           "worst_grad_leaves": worst(grad_err), "worst_param_leaves": worst(param_err),
           "relu_sign_flips_aligned": {k: {"count": n, "max_size_over_layer_max": size}
                                       for k, (n, size) in flips.items()},
           "relu_flips_not_near_zero": flips_bad, "grad_leaves_over_tol": grad_bad}
    emit({"train_card_vs_cpu": res})
    if not (res["loss_rel_err"] <= 1e-4 and res["grad_norm_rel_err"] <= 1e-4
            and not grad_bad and not flips_bad and max(param_over.values()) <= 0):
        raise AssertionError(f"card and CPU train steps differ: {res}")


def overfit_anchor(torch, dev):
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.data.synthetic import (
        batch_from_dataset, make_synthetic_dataset)
    from speech_tranformer_pytorch_tpu_torch.decoding import beam_decode, best_hypotheses
    from speech_tranformer_pytorch_tpu_torch.decoding.beam import EOS
    from speech_tranformer_pytorch_tpu_torch.train import create_train_state, make_train_step

    # The JAX anchor's model (tests/test_train.py:22-31) with the tiny
    # preset's Noam warmup of 100.
    cfg = get_config("tiny", **{
        "model.vocab_size": 32, "model.d_model": 128, "model.num_heads": 4,
        "model.d_ff": 256, "model.num_encoder_layers": 2, "model.num_decoder_layers": 2,
        "model.dropout_rate": 0.0, "model.subsample_channels": 16})
    ds = make_synthetic_dataset(10, vocab_size=32, seed=0)
    batch = batch_from_dataset(ds, cfg.features, device=dev)
    state = create_train_state(cfg, device=dev, seed=0)
    step = make_train_step(cfg)
    t0 = time.perf_counter()
    losses = []
    for _ in range(300):
        state, m = step(state, batch)
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    wall = time.perf_counter() - t0
    state.model.eval()
    res = beam_decode(state.model, batch.feats, batch.frame_lens, beam_size=5,
                      max_len=8, device=dev)
    hyps = [[t for t in h if t != EOS] for h in best_hypotheses(res)]
    emit({"overfit_anchor": {"steps": 300, "first_loss": losses[0],
                             "final_loss": losses[-1], "ratio": losses[-1] / losses[0],
                             "wall_s": wall, "transcripts_exact": hyps == ds.transcripts}})
    if not losses[-1] < 0.35 * losses[0]:
        raise AssertionError(f"loss {losses[0]} -> {losses[-1]}: not below 0.35x")
    if hyps != ds.transcripts:
        raise AssertionError(f"decoded {hyps}, trained on {ds.transcripts}")


def expected_serve_launches(cfg, steps: int, int8: bool, beam: int, ring: int = 1):
    """Exact kernel launches of one served batch of ``steps`` decode steps
    (beam search, or greedy decoding at ``beam == 1``); an encoder layer on
    a ring of ``ring`` ranks runs one flash forward per key block. A hybrid
    CTC/attention search (``decode.ctc_weight`` > 0) runs its prune as the
    pre-beam and one CTC prefix scorer a step; a Conformer encoder one
    relative-position attention a layer and no flash forward; a forced
    prompt of n tokens n - 1 decode steps without a prune first."""
    from speech_tranformer_pytorch_tpu_torch.kernels import interface

    m = cfg.model
    layer_step = (1 if m.fused_qkv else 3) + 3    # self q/k/v, self out, cross q, cross out
    want = {k: 0 for k in interface.launch_counts()}
    want.update({"stft_mel": 1, "beam_prune": steps if beam > 1 else 0,
                 "lineage_attention": m.num_decoder_layers * steps,
                 "cross_attention_decode": m.num_decoder_layers * steps,
                 "flash_fwd": m.num_encoder_layers * ring})
    if m.encoder == "conformer":   # relative-position attention, no flash forward
        want.update(flash_fwd=0, relpos_attention=m.num_encoder_layers)
    forced = max(len(cfg.decode.prompt) - 1, 0)   # the prompt's steps (beam.read_prompt)
    want["lineage_attention"] += m.num_decoder_layers * forced
    want["cross_attention_decode"] += m.num_decoder_layers * forced
    if int8:   # + the cross K and V projections of init_cache
        want["int8_matmul"] = m.num_decoder_layers * (layer_step * steps + 2)
        want["int8_ffn"] = m.num_decoder_layers * steps
    if beam > 1 and cfg.decode.ctc_weight > 0.0:
        want["ctc_prefix"] = steps
    return want


def main_path(torch, dev, int8: bool = False):
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.profile_decode import DECODE, smoke_batch

    # The batch profile_decode.py traces: base preset, seeded random
    # weights, 8 int16 utterances of 4-6 s, beam 5, max_len 100; with
    # ``int8`` the int8 weights and int8 cross-K/V cache. The timed call is
    # the shape's second: its prologue and steps are graph replays.
    cfg, params, rec, audio, lens = smoke_batch(dev, int8=int8)
    warm = rec.decode_result(audio, lens, **DECODE)
    if not bool(torch.isfinite(warm.scores[:, 0]).all()):
        raise AssertionError(f"non-finite best scores {warm.scores[:, 0]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    interface.reset_launch_counts()
    interface.reset_decode_step_counts()
    t0 = time.perf_counter()
    hyps = rec.decode_batch(audio, lens, **DECODE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = interface.launch_counts()
    step_kinds = interface.decode_step_counts()

    steps = rec.last_steps
    v = cfg.model.vocab_size
    if len(hyps) != len(lens) or any(not 0 <= t < v or t == 2 for h in hyps for t in h):
        raise AssertionError(f"malformed hypotheses {hyps}")
    want = expected_serve_launches(cfg, steps, int8, DECODE["beam_size"])
    if steps <= 0 or counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    # The shape's second call: one prologue replay, then a replay a step.
    if step_kinds != step_counts(replays=steps, prologue_replays=1):
        raise AssertionError(f"decode step counts {step_kinds}: expected one prologue "
                             f"replay and {steps} step replays")
    audio_s = float(lens.sum()) / cfg.features.sample_rate
    greedy = {}
    if int8:   # the same batch decoded greedily (beam 1), also with exact counts
        decode = dict(DECODE, beam_size=1)
        rec.decode_batch(audio, lens, **decode)
        torch.cuda.synchronize()
        interface.reset_launch_counts()
        t0 = time.perf_counter()
        ghyps = rec.decode_batch(audio, lens, **decode)
        torch.cuda.synchronize()
        gwall = time.perf_counter() - t0
        gcounts = interface.launch_counts()
        gwant = expected_serve_launches(cfg, rec.last_steps, int8, 1)
        if rec.last_steps <= 0 or gcounts != gwant or len(ghyps) != len(lens):
            raise AssertionError(f"greedy launch counts {gcounts}, expected {gwant}")
        greedy = {"greedy": {"wall_s": gwall, "rtf": gwall / audio_s,
                             "decode_steps": rec.last_steps, "launches": gcounts,
                             "hyp_lens": [len(h) for h in ghyps]}}
    emit({"int8_path" if int8 else "main_path": {**greedy,
        "preset": "base", "dtype": cfg.model.dtype, "utterances": len(lens),
        "int8_weights": cfg.decode.int8_weights, "int8_kv_cache": cfg.decode.int8_kv_cache,
        "beam": DECODE["beam_size"], "max_len": DECODE["max_len"],
        "wall_s": wall, "audio_s": audio_s,
        "rtf": wall / audio_s, "decode_steps": steps,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "decode_step_counts": step_kinds,
        "launches": counts, "hyp_lens": [len(h) for h in hyps]}})
    if not int8:
        gathered_cache_check(torch, dev, params, audio, lens)
    return counts, params, audio, lens


MIX_BUCKETS = (200, 400, 600, 800, 1000, 1400)   # portbench/mixes/serve.aishell-b8.json


def _mix_batches(torch, cfg, buckets=MIX_BUCKETS, batch: int = 8, ratio: float = 0.128):
    """One batch of ``batch`` int16 utterances (seeded) in each length
    bucket of a serving benchmark's mix (by default the ``base`` cell's),
    padded to the bucket's boundary as the port pads its batches, with the
    mix's decode limit (``ratio`` of the encoder frames, 4 to 100):
    [(audio, lens, max_len)], the longest first."""
    import numpy as np

    from speech_tranformer_pytorch_tpu_torch.data.pipeline import _samples_for_frames
    from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances
    from speech_tranformer_pytorch_tpu_torch.models.modules import subsampled_lengths

    f, sr = cfg.features, cfg.features.sample_rate
    out, low = [], 100
    for i, top in enumerate(buckets):
        audio, lens = make_utterances(batch, min_seconds=_samples_for_frames(low + 1, f) / sr,
                                      max_seconds=_samples_for_frames(top, f) / sr, seed=i)
        padded = np.zeros((batch, _samples_for_frames(top, f)), np.int16)
        padded[:, :audio.shape[1]] = audio
        enc = int(subsampled_lengths(torch.tensor(top)))
        out.append((padded, lens, max(4, min(100, int(ratio * enc)))))
        low = top
    return out[::-1]


def step_counts(**counts):
    """A whole ``interface.decode_step_counts()``: ``counts``, every other
    kind 0."""
    from speech_tranformer_pytorch_tpu_torch.kernels import interface

    return {**{kind: 0 for kind in interface.decode_step_counts()}, **counts}


def row_writes_checked(cfg, steps: int, tag: str) -> dict:
    """``interface.row_write_counts()`` since its last reset, which on the
    card must be the lineage kernel's alone, one a decoder layer and step:
    every step, captured, replayed or eager, a forced prompt's steps
    included (``steps`` counts them), writes its self K/V rows inside the
    write-and-attend kernel, and none with ``index_copy_``."""
    from speech_tranformer_pytorch_tpu_torch.kernels import interface

    got = interface.row_write_counts()
    want = {"kernel": cfg.model.num_decoder_layers * steps, "index_copy": 0}
    if got != want:
        raise AssertionError(f"{tag}: self K/V row writes {got}, expected {want}")
    return got


def _prologue_bits(torch, dev, rec, batches, decode: dict) -> dict:
    """Each batch's prologue on a new arena (``beam_graph.StepGraphs.prologue``),
    run eagerly at its first call, then, after the call's search has
    captured it, replayed: the encoder's memory (copied by a probe into a
    buffer made at the eager call, so the capture copies into the same
    one), the cross K/V, the CTC log-probs and lengths, the initial carry,
    the int32 lengths, the index and the first stop flag of the replay must
    equal the eager prologue's bit for bit."""
    from speech_tranformer_pytorch_tpu_torch.decoding import beam_graph

    real, probe = beam_graph.encode_on, {}

    def probing(model, feats, flens, device):
        memory, mem_lens = real(model, feats, flens, device)
        held = probe.get(tuple(memory.shape))
        if held is None:   # at a shape's eager call, outside every capture
            held = probe[tuple(memory.shape)] = torch.empty_like(memory)
        held.copy_(memory)
        return memory, mem_lens

    def snapshot(entry, memory_shape):
        out = {name: view.clone() for name, view in entry.views.items()}
        out["memory"] = probe[memory_shape].clone()
        return out

    graphs, differ, compared = beam_graph.StepGraphs(dev), [], 0
    beam_graph.encode_on = probing
    try:
        with torch.no_grad():
            for audio, lens, max_len in batches:
                kw = dict(decode, max_len=max_len, int8_kv=rec.int8_kv,
                          ctc_weight=rec.ctc_weight)
                entry = graphs.prologue(rec.model, audio, lens, rec.cfg.features, **kw)
                shape = (audio.shape[0], entry.key[3], rec.cfg.model.d_model)
                eager = snapshot(entry, shape)
                graphs._search(rec.model, entry, True)   # captures it
                replayed = snapshot(graphs.prologue(rec.model, audio, lens,
                                                    rec.cfg.features, **kw), shape)
                torch.cuda.synchronize()
                compared += len(eager)
                differ += [{"samples": int(audio.shape[1]), "tensor": name}
                           for name, t in eager.items() if not torch.equal(t, replayed[name])]
    finally:
        beam_graph.encode_on = real
    if differ:
        raise AssertionError(f"replayed prologues differ from the eager ones: {differ}")
    return {"shapes": len(batches), "tensors_equal": compared}


def _pcm_graph_passes(torch, dev, rec, cfg, batches, decode: dict, eager: dict,
                      int8: bool) -> dict:
    """The batches served from their PCM on the model's arena
    (``beam_graph.graph_beam_decode``, the ``Recognizer``'s route on a
    card), on a new arena, largest first: a pass whose calls each run the
    prologue and steps eagerly and capture both, then a pass whose calls
    each replay one prologue and every step. Each call's launches are
    ``expected_serve_launches``, and its hypotheses, lengths, steps and
    scores ``eager``'s (``eager_beam_search`` after the same features and
    encoder). Then ``_prologue_bits``."""
    from speech_tranformer_pytorch_tpu_torch.decoding import beam_graph
    from speech_tranformer_pytorch_tpu_torch.kernels import interface

    beam_graph._GRAPHS.pop(rec.model, None)
    steps = sum(r.steps for r, _ in eager.values())
    n = len(batches)
    prompt = decode.get("prompt")
    forced = 0 if prompt is None else prompt.offset * n   # the prompt's steps, every call

    def run_pass():
        interface.reset_decode_step_counts()
        interface.reset_row_write_counts()
        walls, differ, steps_run = [], [], 0
        for i, (audio, lens, max_len) in enumerate(batches):
            interface.reset_launch_counts()
            t0 = time.perf_counter()
            r = beam_graph.graph_beam_decode(rec.model, audio, lens, cfg.features,
                                             max_len=max_len, int8_kv=rec.int8_kv,
                                             ctc_weight=rec.ctc_weight, **decode)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            steps_run += r.steps
            counts = interface.launch_counts()
            want = expected_serve_launches(cfg, r.steps, int8, decode["beam_size"])
            if counts != want:
                raise AssertionError(f"graph_beam_decode: launch counts {counts}, "
                                     f"expected {want}")
            e = eager[i][0]
            if (r.steps != e.steps or not torch.equal(r.tokens, e.tokens)
                    or not torch.equal(r.lengths, e.lengths)
                    or not torch.equal(r.scores, e.scores)):
                differ.append({"samples": int(audio.shape[1]), "steps": [r.steps, e.steps],
                               "score_diff": float((r.scores - e.scores).abs().max())})
        if differ:
            raise AssertionError(f"PCM graph and eager decodes differ: {differ}")
        row_writes_checked(cfg, steps_run + forced, "graph_beam_decode")
        return walls, interface.decode_step_counts()

    first_s, first_counts = run_pass()
    replayed_s, replay_counts = run_pass()
    want_counts = [step_counts(captures=n, eager_steps=steps, prologue_captures=n,
                               prologue_eager=n),
                   step_counts(replays=steps, prologue_replays=n)]
    if [first_counts, replay_counts] != want_counts:
        raise AssertionError(f"PCM decode step counts {first_counts}, {replay_counts}; "
                             f"expected {want_counts}")
    beam_graph._GRAPHS.pop(rec.model, None)
    return {"decode_step_counts": want_counts, "first_s": sum(first_s),
            "replayed_s": sum(replayed_s), "replayed_call_s": replayed_s,
            "prologue_bits": _prologue_bits(torch, dev, rec, batches, decode)}


def graph_decode(torch, dev):
    """The beam step replayed as CUDA graphs (``decoding/beam_graph.py``)
    against the eager search, at the ``base`` preset's beam-5 float path
    and its int8 path (int8 weights and cross-K/V cache), each on a
    ``Recognizer`` built from parameters on the card, as the serving
    benchmark builds it, and on one batch of each shape of the benchmark's
    mix (``_mix_batches``). Both functions are called directly
    (``beam_graph.graph_beam_search``, ``beam.eager_beam_search``), after
    the same features and encoder (on the batch's first encoding, see
    ``serve``): hypotheses, lengths, steps and scores must be equal, every
    call's launches must be
    ``expected_serve_launches``; the first pass over the shapes (largest
    first) captures each once and replays nothing, the second replays
    every step and captures nothing; after both, the card's memory peak
    stays under the build's. Float path only: a pass smallest first on a
    new arena grows it at every shape and captures every shape seen again
    each time (1 + 2 + ... + 6), after which a pass replays only. Then
    both paths from the PCM (``_pcm_graph_passes``: the ``Recognizer``'s
    route, whose prologue replays once a call after a shape's first)."""
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.data.features import extract_features
    from speech_tranformer_pytorch_tpu_torch.decoding import beam_graph
    from speech_tranformer_pytorch_tpu_torch.decoding.beam import eager_beam_search, encode_on
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer
    from speech_tranformer_pytorch_tpu_torch.profile_decode import DECODE, INT8
    from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer

    beam = DECODE["beam_size"]
    report = {}
    for int8 in (False, True):
        cfg = get_config("base", **(INT8 if int8 else {}))
        params = SpeechTransformer(cfg.model).init_weights(
            torch.Generator().manual_seed(0)).state_dict()
        batches = _mix_batches(torch, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        on_card = {k: v.to(dev) for k, v in params.items()}
        rec = Recognizer(cfg, on_card, device=dev)
        del on_card
        torch.cuda.synchronize()
        build_peak = torch.cuda.max_memory_allocated(dev)
        built = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

        encoded, redrawn, row_writes = {}, [], []

        def serve(fn, i):
            """One call of ``fn`` on batch ``i`` after its features and
            encoder: (result, wall s). Every call runs the encoder (its
            memory and launches are a served call's), and every search
            reads the batch's first encoding, so that all paths decode the
            same input: the encoder's output may differ between calls in its
            last bits (``redrawn`` notes each call where it did)."""
            audio, lens, max_len = batches[i]
            interface.reset_launch_counts()
            t0 = time.perf_counter()
            with torch.no_grad():
                feats, flens = extract_features(audio, lens, cfg.features, device=dev)
                memory, mem_lens = encode_on(rec.model, feats, flens, dev)
                first, first_lens = encoded.setdefault(i, (memory, mem_lens))
                r = fn(rec.model, first, first_lens, beam_size=beam, max_len=max_len,
                       alpha=DECODE["alpha"], int8_kv=rec.int8_kv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = interface.launch_counts()
            want = expected_serve_launches(cfg, r.steps, int8, beam)
            if r.steps <= 0 or counts != want:
                raise AssertionError(f"{fn.__name__}: launch counts {counts}, expected {want}")
            if not torch.equal(memory, first):
                redrawn.append(i)
            return r, wall

        def run_pass(fn, order):
            interface.reset_decode_step_counts()
            interface.reset_row_write_counts()
            out = {i: serve(fn, i) for i in order}
            row_writes.append(row_writes_checked(
                cfg, sum(r.steps for r, _ in out.values()), fn.__name__))
            return out, interface.decode_step_counts()

        shapes = range(len(batches))
        first, first_counts = run_pass(beam_graph.graph_beam_search, shapes)
        replayed, replay_counts = run_pass(beam_graph.graph_beam_search, shapes)
        serve_peak = torch.cuda.max_memory_allocated(dev)
        arena = beam_graph._GRAPHS[rec.model]
        arena_bytes = sum(b.numel() * b.element_size() for b in arena._buffers.values())
        eager, eager_counts = run_pass(eager_beam_search, shapes)
        steps = sum(r.steps for r, _ in eager.values())
        want_counts = [step_counts(captures=len(batches), eager_steps=steps),
                       step_counts(replays=steps), step_counts(eager_steps=steps)]
        if [first_counts, replay_counts, eager_counts] != want_counts:
            raise AssertionError(f"decode step counts {first_counts}, {replay_counts}, "
                                 f"{eager_counts}; expected {want_counts}")
        score_diff, differ = 0.0, []
        for i in shapes:
            e = eager[i][0]
            for tag, (g, _) in (("first", first[i]), ("replayed", replayed[i])):
                diff = float((g.scores - e.scores).abs().max())
                score_diff = max(score_diff, diff)
                if (g.steps != e.steps or not torch.equal(g.tokens, e.tokens)
                        or not torch.equal(g.lengths, e.lengths)
                        or not torch.equal(g.scores, e.scores)):
                    differ.append({"pass": tag, "samples": int(batches[i][0].shape[1]),
                                   "steps": [g.steps, e.steps], "score_diff": diff,
                                   "tokens_equal": bool(torch.equal(g.tokens, e.tokens))})
        if differ:
            raise AssertionError(f"{'int8' if int8 else 'float'} graph and eager decodes "
                                 f"differ: {differ}")
        if not serve_peak < build_peak:
            raise AssertionError(f"graph serving peak {serve_peak} B is not under the "
                                 f"build's {build_peak} B")
        res = {"encoder_output_redrawn": len(redrawn),
               "build_peak_bytes": build_peak, "built_bytes": built,
               "serve_peak_bytes": serve_peak,
               "arena_bytes": arena_bytes, "steps": steps,
               "widest_score_diff": score_diff, "decode_step_counts": want_counts,
               "row_writes": row_writes,
               "shapes": [{"samples": int(batches[i][0].shape[1]), "max_len": batches[i][2],
                           "steps": eager[i][0].steps, "eager_s": eager[i][1],
                           "first_s": first[i][1], "replayed_s": replayed[i][1]}
                          for i in shapes]}
        res["eager_s"] = sum(w for _, w in eager.values())
        res["replayed_s"] = sum(w for _, w in replayed.values())
        if not int8:   # a new arena, smallest first: it grows at every shape
            del beam_graph._GRAPHS[rec.model]
            grown, grown_counts = run_pass(beam_graph.graph_beam_search, shapes[::-1])
            again, again_counts = run_pass(beam_graph.graph_beam_search, shapes)
            n = len(batches)
            want_growth = [step_counts(captures=n * (n + 1) // 2, eager_steps=steps),
                           step_counts(replays=steps)]
            if [grown_counts, again_counts] != want_growth:
                raise AssertionError(f"growing arena: decode step counts {grown_counts}, "
                                     f"{again_counts}; expected {want_growth}")
            for i in shapes:
                for g, _ in (grown[i], again[i]):
                    if not (torch.equal(g.tokens, eager[i][0].tokens)
                            and torch.equal(g.scores, eager[i][0].scores)):
                        raise AssertionError(f"growing arena: {batches[i][0].shape} differs")
            res["growth_counts"] = want_growth
        res["pcm"] = _pcm_graph_passes(torch, dev, rec, cfg, batches,
                                       dict(beam_size=beam, alpha=DECODE["alpha"]), eager,
                                       int8)
        report["int8" if int8 else "float"] = res
        del rec, arena
        beam_graph._GRAPHS.clear()
    emit({"graph_decode": report})


# CTC prefix scoring (``kernels/ctc_prefix.py``) at the shape of the
# `librispeech` cell's longest calls: 16 utterances of up to 749 encoder
# frames (lengths 749 down to 374), beam 5, pre-beam 7, V 5000, log-probs
# padded past each utterance's frames as ESPnet pads them. Four steps from
# the <sos> state (n 0 to 3), each with an <eos> and (from n 1) a repeated
# candidate, with n a device int32 (every decode step's index). psi and
# the states within 1e-3 plus 1e-5 of each value of the plain version
# (float32 summed in another order: the kernel scans the frames in 32
# chunks), bit-identical on a second call. Timed at n 3.
CTC_SHAPE = (16, 5, 749, 5000)          # batch, beam, encoder frames, vocabulary
CTC_TOL = (1e-3, 1e-5)                  # atol, rtol
CTC_BUCKETS = (200, 400, 600, 800, 1000, 1400, 2000, 3000)   # portbench/mixes/serve.ls-b16.json
CTC_RATIO = 0.14


def check_ctc_prefix(torch, dev):
    from portbench.work.ctc import step_counts
    from speech_tranformer_pytorch_tpu_torch.kernels import ctc_prefix

    b, k, t, v = CTC_SHAPE
    p = int(1.5 * k)
    g = torch.Generator(device=dev).manual_seed(0)
    lens = torch.linspace(t, t // 2, b, device=dev).round().int()
    logp = torch.log_softmax(1.5 * torch.randn(b, t, v, generator=g, device=dev), -1)
    pad = torch.full((v,), ctc_prefix.LOGZERO, device=dev)
    pad[0] = 0.0
    valid = torch.arange(t, device=dev)[None, :, None] < lens[:, None, None]
    logp = torch.where(valid, logp, pad).transpose(1, 2).contiguous()      # [B, V, T]
    state = torch.stack([torch.full_like(logp[:, 0], ctc_prefix.LOGZERO),
                         torch.cumsum(logp[:, 0], 1)], 1).repeat_interleave(k, 0)
    last = torch.ones(b * k, dtype=torch.int32, device=dev)               # <sos>
    errs, timed = [], None
    for n in range(4):
        cand = torch.randint(3, v, (b * k, p), generator=g, device=dev, dtype=torch.int32)
        cand[:, 0] = 2                                                      # <eos>
        if n:
            cand[:, 1] = last                                               # a repeat
        index = torch.tensor(n, dtype=torch.int32, device=dev)
        want = ctc_prefix.ctc_prefix_reference(logp, state, last, cand, index, lens, beams=k)
        got = ctc_prefix.ctc_prefix_cuda(logp, state, last, cand, index, lens, beams=k)
        again = ctc_prefix.ctc_prefix_cuda(logp, state, last, cand, index, lens, beams=k)
        torch.cuda.synchronize()
        name = f"ctc_prefix[n={n}]"
        err = (check_close(name + ".psi", got[0], want[0], *CTC_TOL),
               check_close(name + ".states", got[1], want[1], *CTC_TOL))
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        emit({"check": {"name": name, "max_abs_err": list(err), "second_call_bit_equal": same}})
        if not same:
            raise AssertionError(f"{name}: differs on a second call")
        errs += list(err)
        timed = (state, last, cand, n, index)
        state, last = want[1][:, 2].contiguous(), cand[:, 2].contiguous()
    state, last, cand, n, index = timed
    ms = device_ms(torch, lambda: ctc_prefix.ctc_prefix_cuda(logp, state, last, cand, index,
                                                             lens, beams=k))
    plain_ms = device_ms(torch, lambda: ctc_prefix.ctc_prefix_reference(
        logp, state, last, cand, index, lens, beams=k), reps=2, rounds=3)
    kernels_per_call = device_kernels_per_call(
        torch, lambda: ctc_prefix.ctc_prefix_cuda(logp, state, last, cand, index, lens,
                                                  beams=k))
    bound_ms, bound_by = bound(*step_counts(lens.tolist(), k, n))
    rec = dict(name="ctc_prefix", source=f"{PKG}/csrc/ctc_prefix.cu",
               replaces="none: the port's own (the JAX package has no CTC head)",
               max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None,
               library_note="no PyTorch call scores CTC prefixes",
               device_kernels_per_call=kernels_per_call, shape=[b * k, p, t, v])
    emit({"check": rec})
    if kernels_per_call != 1:
        raise AssertionError(f"ctc_prefix: {kernels_per_call} device kernels a call, not 1")
    return rec


def ctc_decode(torch, dev):
    """The hybrid CTC/attention search of the `librispeech` cell
    (``portbench/configs/librispeech.json``: 12 + 6 layers, V 5000, CTC
    weight 0.4) on a ``Recognizer`` on seeded weights (<eos>'s row zeroed,
    as the benchmark serves), one batch of 16 in each bucket of the cell's
    mix: the kernel checked first (``check_ctc_prefix``), then the graph
    search (``beam_graph.graph_beam_search``, a pass capturing every shape
    and a pass replaying) against the eager one after the same encoding:
    hypotheses, lengths, steps and scores equal, every call's launches
    ``expected_serve_launches`` (one prune and one CTC scorer a step);
    then the same from the PCM (``_pcm_graph_passes``)."""
    from speech_tranformer_pytorch_tpu_torch.config import config_from_dict
    from speech_tranformer_pytorch_tpu_torch.data.features import extract_features
    from speech_tranformer_pytorch_tpu_torch.decoding import beam_graph
    from speech_tranformer_pytorch_tpu_torch.decoding.beam import eager_beam_search, encode_on
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer
    from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer

    rec_kernel = check_ctc_prefix(torch, dev)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench",
                           "configs", "librispeech.json")) as f:
        cfg = config_from_dict(json.load(f)["config"]).validate()
    beam, weight = cfg.decode.beam_size, cfg.decode.ctc_weight
    model = SpeechTransformer(cfg.model).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.decoder.embed.weight[2].zero_()
    rec = Recognizer(cfg, {k: t.to(dev) for k, t in model.state_dict().items()}, device=dev)
    del model
    batches = _mix_batches(torch, cfg, CTC_BUCKETS, CTC_SHAPE[0], CTC_RATIO)
    encoded, total = {}, {k: 0 for k in interface.launch_counts()}
    row_writes = []

    def serve(fn, i):
        audio, lens, max_len = batches[i]
        interface.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            feats, flens = extract_features(audio, lens, cfg.features, device=dev)
            memory, mem_lens = encode_on(rec.model, feats, flens, dev)
            first, first_lens = encoded.setdefault(i, (memory, mem_lens))
            r = fn(rec.model, first, first_lens, beam_size=beam, max_len=max_len, alpha=1.0,
                   ctc_weight=weight)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = interface.launch_counts()
        want = expected_serve_launches(cfg, r.steps, False, beam)
        if r.steps <= 0 or counts != want:
            raise AssertionError(f"{fn.__name__}: launch counts {counts}, expected {want}")
        for name, c in counts.items():
            total[name] += c
        return r, wall

    def run_pass(fn):
        interface.reset_decode_step_counts()
        interface.reset_row_write_counts()
        out = {i: serve(fn, i) for i in range(len(batches))}
        row_writes.append(row_writes_checked(
            cfg, sum(r.steps for r, _ in out.values()), fn.__name__))
        return out, interface.decode_step_counts()

    first, first_counts = run_pass(beam_graph.graph_beam_search)
    replayed, replay_counts = run_pass(beam_graph.graph_beam_search)
    eager, eager_counts = run_pass(eager_beam_search)
    steps = sum(r.steps for r, _ in eager.values())
    want_counts = [step_counts(captures=len(batches), eager_steps=steps),
                   step_counts(replays=steps), step_counts(eager_steps=steps)]
    if [first_counts, replay_counts, eager_counts] != want_counts:
        raise AssertionError(f"decode step counts {first_counts}, {replay_counts}, "
                             f"{eager_counts}; expected {want_counts}")
    differ = []
    for i, (e, _) in eager.items():
        for tag, (g, _) in (("first", first[i]), ("replayed", replayed[i])):
            if (g.steps != e.steps or not torch.equal(g.tokens, e.tokens)
                    or not torch.equal(g.lengths, e.lengths)
                    or not torch.equal(g.scores, e.scores)):
                differ.append({"pass": tag, "samples": int(batches[i][0].shape[1]),
                               "steps": [g.steps, e.steps],
                               "score_diff": float((g.scores - e.scores).abs().max()),
                               "tokens_equal": bool(torch.equal(g.tokens, e.tokens))})
    if differ:
        raise AssertionError(f"hybrid graph and eager decodes differ: {differ}")
    arena = beam_graph._GRAPHS[rec.model]
    arena_bytes = sum(x.numel() * x.element_size() for x in arena._buffers.values())
    del arena
    pcm = _pcm_graph_passes(torch, dev, rec, cfg, batches, dict(beam_size=beam, alpha=1.0),
                            eager, False)
    emit({"ctc_decode": {
        "preset": "librispeech", "ctc_weight": weight, "steps": steps,
        "decode_step_counts": want_counts, "row_writes": row_writes, "pcm": pcm,
        "arena_bytes": arena_bytes,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "finite": all(bool(torch.isfinite(r.scores).all()) for r, _ in eager.values()),
        "shapes": [{"samples": int(batches[i][0].shape[1]), "max_len": batches[i][2],
                    "steps": eager[i][0].steps, "eager_s": eager[i][1],
                    "first_s": first[i][1], "replayed_s": replayed[i][1]}
                   for i in range(len(batches))]}})
    del rec
    beam_graph._GRAPHS.clear()
    return rec_kernel, total


# The Conformer's relative-position attention (``kernels/relpos_attention.py``)
# at the `conformer.serve.ls-long-b32` cell's three bucket shapes (B 32,
# H 8, D 64, T' 349 / 499 / 749 with lengths from T' down to the bucket's
# previous boundary), at T' 1, with an utterance of length 0 padded, and at
# H 4 / D 128; q, k, v the views of one fused [B, T', 3, H, D] projection,
# as the model hands them. Within 2e-2 of each output plus 2e-2 relative of
# the plain version (float32 of the same bf16 values: the kernel rounds the
# softmax weights to bf16 before P·V at other points of its online softmax,
# and rounds the output to bf16, a relative step of 2^-8; FLASH_TOL's bf16
# reason), bit-identical on a second call. Timed at the 3000 bucket beside
# its bound, the plain version and the materialised route (ESPnet's, bf16:
# the [B, H, T', 2T'-1] position term, ``rel_shift``, softmax, P·V). Its
# kernels are not counted by the profiler (a second profiler session in a
# process can read no device events, and `check_ctc_prefix` counts by one):
# the wrapper makes one launch a call.
RELPOS_CASES = (("bucket_1400", 32, 349, 8, 64, 249), ("bucket_2000", 32, 499, 8, 64, 349),
                ("bucket_3000", 32, 749, 8, 64, 499), ("t1", 2, 1, 8, 64, 0),
                ("zero_length", 3, 100, 8, 64, -1), ("h4_d128", 4, 300, 4, 128, 120))
RELPOS_TOL = (2e-2, 2e-2)
CONFORMER_BUCKETS = (1400, 2000, 3000)   # portbench/mixes/serve.ls-long-b32.json
CONFORMER_BATCH = 32


def _relpos_inputs(torch, dev, g, b, t, h, d, low):
    """(q, k, v, p, u, vb, lengths int32) of one case; ``low`` -1 gives an
    utterance of length 0 among full ones."""
    qkv = torch.randn(b, t, 3, h, d, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    p = torch.randn(2 * t - 1, h, d, generator=g, device=dev).to(torch.bfloat16)
    u, vb = (0.5 * torch.randn(2, h, d, generator=g, device=dev)).to(torch.bfloat16).unbind(0)
    if low < 0:
        lens = torch.tensor([t, 0] + [t // 3] * (b - 2), device=dev)
    else:
        lens = torch.linspace(t, max(low, 1 if t > 1 else t), b, device=dev).round()
        if t == 1:
            lens = torch.tensor([1, 0][:b], device=dev)
    return q, k, v, p, u, vb, lens.int().contiguous()


def _relpos_materialised(torch, q, k, v, p, u, vb, lens):
    """ESPnet's route in bf16: both score terms as GEMMs, the position term
    [B, H, T, 2T-1] shifted by its pad-and-view, masked softmax, P·V."""
    b, t, h, d = q.shape
    qt = q.transpose(1, 2)
    ac = torch.matmul(qt + u[:, None], k.transpose(1, 2).transpose(-1, -2))
    bd = torch.matmul(qt + vb[:, None], p.permute(1, 2, 0))                # [B, H, T, 2T-1]
    n = bd.shape[-1]
    bd = torch.cat([bd.new_zeros(b, h, t, 1), bd], -1).view(b, h, n + 1, t)[:, :, 1:]
    bd = bd.reshape(b, h, t, n)[..., :t]
    keep = torch.arange(t, device=q.device)[None, :] < lens[:, None]
    s = ((ac + bd) / math.sqrt(d)).masked_fill(~keep[:, None, None, :], float("-inf"))
    return torch.matmul(torch.softmax(s, -1), v.transpose(1, 2)).transpose(1, 2)


def check_relpos_attention(torch, dev):
    from portbench.work.conformer import relpos_counts
    from speech_tranformer_pytorch_tpu_torch.kernels import relpos_attention as rp

    g = torch.Generator(device=dev).manual_seed(0)
    errs, timed = {}, None
    for name, b, t, h, d, low in RELPOS_CASES:
        args = _relpos_inputs(torch, dev, g, b, t, h, d, low)
        got = rp.relpos_attention_cuda(*args)
        again = rp.relpos_attention_cuda(*args)
        want = rp.relpos_attention_reference(*args)
        torch.cuda.synchronize()
        err = check_close(f"relpos_attention[{name}]", got, want, *RELPOS_TOL)
        same = bool(torch.equal(got, again))
        emit({"check": {"name": f"relpos_attention[{name}]", "shape": [b, t, h, d],
                        "lengths": [int(args[-1].min()), int(args[-1].max())],
                        "max_abs_err": err, "second_call_bit_equal": same}})
        if not same:
            raise AssertionError(f"relpos_attention[{name}]: differs on a second call")
        errs[name] = err
        if name == "bucket_3000":
            timed = args
    ms = device_ms(torch, lambda: rp.relpos_attention_cuda(*timed))
    plain_ms = device_ms(torch, lambda: rp.relpos_attention_reference(*timed), reps=2,
                         rounds=3)
    library_ms = device_ms(torch, lambda: _relpos_materialised(torch, *timed), reps=5,
                           rounds=3)
    q = timed[0]
    bound_ms, bound_by = bound(*relpos_counts(timed[-1].tolist(), q.shape[2], q.shape[3]),
                               H100_BF16_FLOP_PER_S)
    rec = dict(name="relpos_attention", source=f"{PKG}/csrc/relpos_attention.cu",
               replaces="none: the port's own (the JAX package has no Conformer)",
               max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms,
               library_note="ESPnet's materialised route in bf16 (GEMMs, rel_shift, "
                            "softmax, P·V)", shape=list(q.shape), errs=errs)
    emit({"check": rec})
    return rec


def conformer_decode(torch, dev, check_kernel: bool = True):
    """The hybrid CTC/attention search of the `conformer.serve.ls-long-b32`
    cell (``portbench/configs/conformer.json``: 12 Conformer blocks + 6
    decoder layers, V 5000, CTC weight 0.3) on a ``Recognizer`` on seeded
    weights (<eos>'s row zeroed, BatchNorm running statistics drawn far from
    the identity), one batch of 32 in each bucket of the cell's mix: the
    kernel checked first (``check_relpos_attention``), then the graph
    search against the eager one after the same encoding (hypotheses,
    lengths, steps and scores equal; every call's launches exact: 12
    ``relpos_attention`` and no ``flash_fwd`` in the encoder), then the same
    from the PCM (``_pcm_graph_passes``: prologue replays = calls, step
    replays = Σ steps, the replayed prologue's memory and CTC log-probs
    bit-equal to the eager one's). ``check_kernel`` False: the kernel check
    ran as its own phase."""
    from speech_tranformer_pytorch_tpu_torch.config import config_from_dict
    from speech_tranformer_pytorch_tpu_torch.data.features import extract_features
    from speech_tranformer_pytorch_tpu_torch.decoding import beam_graph
    from speech_tranformer_pytorch_tpu_torch.decoding.beam import eager_beam_search, encode_on
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer
    from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer

    rec_kernel = check_relpos_attention(torch, dev) if check_kernel else None
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench",
                           "configs", "conformer.json")) as f:
        cfg = config_from_dict(json.load(f)["config"]).validate()
    beam, weight = cfg.decode.beam_size, cfg.decode.ctc_weight
    gen = torch.Generator().manual_seed(0)
    model = SpeechTransformer(cfg.model).init_weights(gen)
    with torch.no_grad():
        model.decoder.embed.weight[2].zero_()
        for layer in model.encoder.layers:
            norm = layer.conv.norm
            norm.running_mean.normal_(0.0, 0.3, generator=gen)
            norm.running_var.uniform_(0.5, 2.0, generator=gen)
    rec = Recognizer(cfg, {k: t.to(dev) for k, t in model.state_dict().items()}, device=dev)
    del model
    torch.cuda.reset_peak_memory_stats(dev)
    batches = _mix_batches(torch, cfg, CONFORMER_BUCKETS, CONFORMER_BATCH, CTC_RATIO)
    encoded, total = {}, {k: 0 for k in interface.launch_counts()}
    row_writes = []

    def serve(fn, i):
        audio, lens, max_len = batches[i]
        interface.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            feats, flens = extract_features(audio, lens, cfg.features, device=dev)
            memory, mem_lens = encode_on(rec.model, feats, flens, dev)
            first, first_lens = encoded.setdefault(i, (memory, mem_lens))
            r = fn(rec.model, first, first_lens, beam_size=beam, max_len=max_len, alpha=1.0,
                   ctc_weight=weight)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = interface.launch_counts()
        want = expected_serve_launches(cfg, r.steps, False, beam)
        if r.steps <= 0 or counts != want:
            raise AssertionError(f"{fn.__name__}: launch counts {counts}, expected {want}")
        for name, c in counts.items():
            total[name] += c
        return r, wall

    def run_pass(fn):
        interface.reset_decode_step_counts()
        interface.reset_row_write_counts()
        out = {i: serve(fn, i) for i in range(len(batches))}
        row_writes.append(row_writes_checked(
            cfg, sum(r.steps for r, _ in out.values()), fn.__name__))
        return out, interface.decode_step_counts()

    first, first_counts = run_pass(beam_graph.graph_beam_search)
    replayed, replay_counts = run_pass(beam_graph.graph_beam_search)
    eager, eager_counts = run_pass(eager_beam_search)
    steps = sum(r.steps for r, _ in eager.values())
    want_counts = [step_counts(captures=len(batches), eager_steps=steps),
                   step_counts(replays=steps), step_counts(eager_steps=steps)]
    if [first_counts, replay_counts, eager_counts] != want_counts:
        raise AssertionError(f"decode step counts {first_counts}, {replay_counts}, "
                             f"{eager_counts}; expected {want_counts}")
    differ = []
    for i, (e, _) in eager.items():
        for tag, (g, _) in (("first", first[i]), ("replayed", replayed[i])):
            if (g.steps != e.steps or not torch.equal(g.tokens, e.tokens)
                    or not torch.equal(g.lengths, e.lengths)
                    or not torch.equal(g.scores, e.scores)):
                differ.append({"pass": tag, "samples": int(batches[i][0].shape[1]),
                               "steps": [g.steps, e.steps],
                               "score_diff": float((g.scores - e.scores).abs().max()),
                               "tokens_equal": bool(torch.equal(g.tokens, e.tokens))})
    if differ:
        raise AssertionError(f"Conformer graph and eager decodes differ: {differ}")
    arena = beam_graph._GRAPHS[rec.model]
    arena_bytes = sum(x.numel() * x.element_size() for x in arena._buffers.values())
    del arena
    pcm = _pcm_graph_passes(torch, dev, rec, cfg, batches, dict(beam_size=beam, alpha=1.0),
                            eager, False)
    encoder_ms = {}     # the encoder alone at each bucket's batch, features excluded
    with torch.no_grad():
        for audio, lens, _ in batches:
            feats, flens = extract_features(audio, lens, cfg.features, device=dev)
            encoder_ms[int(audio.shape[1])] = device_ms(
                torch, lambda: rec.model.encode(feats, flens), reps=3, rounds=3)
    emit({"conformer_decode": {
        "preset": "conformer", "ctc_weight": weight, "steps": steps,
        "encoder_ms": encoder_ms,
        "decode_step_counts": want_counts, "row_writes": row_writes, "pcm": pcm,
        "arena_bytes": arena_bytes,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "finite": all(bool(torch.isfinite(r.scores).all()) for r, _ in eager.values()),
        "shapes": [{"samples": int(batches[i][0].shape[1]), "max_len": batches[i][2],
                    "steps": eager[i][0].steps, "eager_s": eager[i][1],
                    "first_s": first[i][1], "replayed_s": replayed[i][1]}
                   for i in range(len(batches))]}})
    del rec
    beam_graph._GRAPHS.clear()
    return rec_kernel, total


WHISPER_BUCKETS = (1400, 2000, 3000)   # portbench/mixes/serve.whisper-30s-b16.json
WHISPER_BATCH = 16
WHISPER_RATIO = 0.132


def whisper_decode(torch, dev):
    """Whisper large-v3 as the `whisper.serve.long-b16` cell serves it
    (``portbench/configs/whisper.json``: 32 + 32 layers at d_model 1280,
    V 51,866, the forced 4-token prompt and the suppression) on a
    ``Recognizer`` on seeded weights (<|endoftext|>'s row zeroed), one
    batch of 16 in each bucket of the cell's mix (46/65/98 steps): the
    log-mel on the card (the DFT kernel) against the plain version on the
    CPU; the prune's two-launch route at V 51,866 against its plain
    version; the graph search against the eager one after the same
    encoding (hypotheses, lengths, steps and scores equal; every call's
    launches exact: 32 lineage and 32 cross-attention launches a step, the
    prompt's 3 forced steps included; row writes 32 a step by the kernel,
    the forced steps included); then the same from the PCM
    (``_pcm_graph_passes``: prologue replays = calls, the replayed
    prologue's memory, caches and carry bit-equal to the eager one's).
    Times the encoder and the replayed calls."""
    from speech_tranformer_pytorch_tpu_torch.config import config_from_dict
    from speech_tranformer_pytorch_tpu_torch.data.features import extract_features
    from speech_tranformer_pytorch_tpu_torch.decoding import beam_graph
    from speech_tranformer_pytorch_tpu_torch.decoding.beam import eager_beam_search, encode_on
    from speech_tranformer_pytorch_tpu_torch.kernels import beam_prune, interface
    from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer
    from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench",
                           "configs", "whisper.json")) as f:
        cfg = config_from_dict(json.load(f)["config"]).validate()
    beam = cfg.decode.beam_size
    batches = _mix_batches(torch, cfg, WHISPER_BUCKETS, WHISPER_BATCH, WHISPER_RATIO)
    mel_err = {}
    for audio, lens, _ in batches:     # the log-mel kernel against the plain version
        card, _ = extract_features(audio, lens, cfg.features.replace(output_dtype="float32"),
                                   device=dev)
        plain, _ = extract_features(audio, lens, cfg.features.replace(output_dtype="float32"),
                                    device="cpu")
        mel_err[int(audio.shape[1])] = float((card.cpu() - plain).abs().max())
    if not max(mel_err.values()) <= 1e-3:
        raise AssertionError(f"Whisper log-mel on the card differs from the plain version: "
                             f"{mel_err}")
    logits = torch.randn((WHISPER_BATCH * beam, cfg.model.vocab_size), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(7)) * 3.0
    alive = torch.randn((WHISPER_BATCH, beam), device=dev)
    if beam_prune.plan(beam, 2 * beam, cfg.model.vocab_size) != "rows":
        raise AssertionError("the prune at V 51,866 is expected on its two-launch route")
    got = beam_prune.candidate_topk_cuda(logits, alive, k2=2 * beam)
    want = beam_prune.candidate_topk_reference(logits.cpu(), alive.cpu(), k2=2 * beam)
    if not torch.equal(got[1].cpu(), want[1]):
        raise AssertionError("the prune's rows route differs from its plain version at "
                             "V 51,866")
    gen = torch.Generator().manual_seed(0)
    model = SpeechTransformer(cfg.model).init_weights(gen)
    with torch.no_grad():
        model.decoder.embed.weight[2].zero_()
    rec = Recognizer(cfg, {k: t.to(dev) for k, t in model.state_dict().items()}, device=dev)
    del model
    torch.cuda.reset_peak_memory_stats(dev)
    prompt = rec.prompt
    encoded, total = {}, {k: 0 for k in interface.launch_counts()}
    row_writes = []

    def serve(fn, i):
        audio, lens, max_len = batches[i]
        interface.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            feats, flens = extract_features(audio, lens, cfg.features, device=dev)
            memory, mem_lens = encode_on(rec.model, feats, flens, dev)
            first, first_lens = encoded.setdefault(i, (memory, mem_lens))
            r = fn(rec.model, first, first_lens, beam_size=beam, max_len=max_len, alpha=1.0,
                   prompt=prompt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = interface.launch_counts()
        want = expected_serve_launches(cfg, r.steps, False, beam)
        if r.steps <= 0 or counts != want:
            raise AssertionError(f"{fn.__name__}: launch counts {counts}, expected {want}")
        for name, c in counts.items():
            total[name] += c
        return r, wall

    def run_pass(fn):
        interface.reset_decode_step_counts()
        interface.reset_row_write_counts()
        out = {i: serve(fn, i) for i in range(len(batches))}
        row_writes.append(row_writes_checked(
            cfg, sum(r.steps + prompt.offset for r, _ in out.values()), fn.__name__))
        return out, interface.decode_step_counts()

    first, first_counts = run_pass(beam_graph.graph_beam_search)
    replayed, replay_counts = run_pass(beam_graph.graph_beam_search)
    eager, eager_counts = run_pass(eager_beam_search)
    steps = sum(r.steps for r, _ in eager.values())
    want_counts = [step_counts(captures=len(batches), eager_steps=steps),
                   step_counts(replays=steps), step_counts(eager_steps=steps)]
    if [first_counts, replay_counts, eager_counts] != want_counts:
        raise AssertionError(f"decode step counts {first_counts}, {replay_counts}, "
                             f"{eager_counts}; expected {want_counts}")
    differ = []
    for i, (e, _) in eager.items():
        for tag, (g, _) in (("first", first[i]), ("replayed", replayed[i])):
            if (g.steps != e.steps or not torch.equal(g.tokens, e.tokens)
                    or not torch.equal(g.lengths, e.lengths)
                    or not torch.equal(g.scores, e.scores)):
                differ.append({"pass": tag, "samples": int(batches[i][0].shape[1]),
                               "steps": [g.steps, e.steps],
                               "score_diff": float((g.scores - e.scores).abs().max()),
                               "tokens_equal": bool(torch.equal(g.tokens, e.tokens))})
    if differ:
        raise AssertionError(f"Whisper graph and eager decodes differ: {differ}")
    suppressed = set(cfg.decode.suppress)
    for r, _ in eager.values():
        toks = r.tokens.cpu()
        if (set(toks.flatten().tolist()) & suppressed
                or set(toks[:, :, 0].flatten().tolist()) & set(cfg.decode.suppress_first)):
            raise AssertionError("a suppressed id was emitted")
    arena = beam_graph._GRAPHS[rec.model]
    arena_bytes = sum(x.numel() * x.element_size() for x in arena._buffers.values())
    del arena
    pcm = _pcm_graph_passes(torch, dev, rec, cfg, batches,
                            dict(beam_size=beam, alpha=1.0, prompt=prompt), eager, False)
    encoder_ms = {}     # the encoder alone at each bucket's batch, features excluded
    with torch.no_grad():
        for audio, lens, _ in batches:
            feats, flens = extract_features(audio, lens, cfg.features, device=dev)
            encoder_ms[int(audio.shape[1])] = device_ms(
                torch, lambda: rec.model.encode(feats, flens), reps=2, rounds=3)
    emit({"whisper_decode": {
        "preset": "whisper_large_v3", "steps": steps, "mel_max_abs_err": mel_err,
        "encoder_ms": encoder_ms, "decode_step_counts": want_counts,
        "row_writes": row_writes, "pcm": pcm, "arena_bytes": arena_bytes,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "finite": all(bool(torch.isfinite(r.scores).all()) for r, _ in eager.values()),
        "shapes": [{"samples": int(batches[i][0].shape[1]), "max_len": batches[i][2],
                    "steps": eager[i][0].steps, "eager_s": eager[i][1],
                    "first_s": first[i][1], "replayed_s": replayed[i][1]}
                   for i in range(len(batches))]}})
    del rec
    beam_graph._GRAPHS.clear()
    return total


def card_vs_cpu(torch, dev, params, audio, lens, int8: bool = False):
    """float32 on 2 utterances, the kernels on the card against the plain
    versions on the CPU: hypotheses identical, first-step logits within
    1e-3. With ``int8``: the int8 weights and K/V cache, at beam 5 and at
    beam 1 (greedy)."""
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.data.features import extract_features
    from speech_tranformer_pytorch_tpu_torch.profile_decode import DECODE, INT8
    from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer

    cfg = get_config("base", **{"model.dtype": "float32",
                                "features.output_dtype": "float32",
                                **(INT8 if int8 else {})})
    max_len = DECODE["max_len"]
    lens2 = lens[:2]
    audio2 = audio[:2, :int(lens2.max())]
    report = {}
    for beam in ((DECODE["beam_size"], 1) if int8 else (DECODE["beam_size"],)):
        decode = dict(DECODE, beam_size=beam)
        out = []
        for where in (dev, torch.device("cpu")):
            rec = Recognizer(cfg, params, device=where)
            result = rec.decode_result(audio2, lens2, **decode)
            hyps = rec.hypotheses(result)
            with torch.no_grad():
                feats, flens = extract_features(audio2, lens2, cfg.features, device=where)
                memory, mem_lens = rec.model.encode(feats, flens)
                cache = rec.model.init_cache(memory, max_len, beam, rec.int8_kv)
                lineage = torch.arange(beam, dtype=torch.int32, device=where)[
                    None, :, None].expand(2, beam, max_len).contiguous()
                sos = torch.full((2 * beam,), 1, dtype=torch.int32, device=where)
                step0 = torch.zeros((), dtype=torch.int32, device=where)
                logits, _ = rec.model.decode_step(sos, step0, cache, mem_lens, beam, lineage)
            scores = getattr(result, "scores", None)
            out.append((hyps, None if scores is None else scores.cpu(), logits.cpu()))
        (hyp_g, sc_g, lg_g), (hyp_c, sc_c, lg_c) = out
        logit_err = float((lg_g - lg_c).abs().max())
        res = {"hyps_equal": hyp_g == hyp_c, "first_step_logit_err": logit_err,
               "hyp_lens": [len(h) for h in hyp_g]}
        if sc_c is not None:
            res["top2_score_gap_cpu"] = [float(sc_c[i, 0] - sc_c[i, 1])
                                         for i in range(sc_c.shape[0])]
            res["score_err"] = float((sc_g - sc_c).abs().max())
        report[f"beam_{beam}"] = res
        if hyp_g != hyp_c:
            raise AssertionError(f"beam {beam}: card and CPU hypotheses differ: "
                                 f"{hyp_g} vs {hyp_c}")
        if not logit_err <= 1e-3:
            raise AssertionError(f"beam {beam}: first-step logits differ by {logit_err}")
    emit({"int8_card_vs_cpu" if int8 else "card_vs_cpu":
          report if int8 else report[f"beam_{DECODE['beam_size']}"]})


def gathered_cache_check(torch, dev, params, audio, lens):
    """The main path's batch decoded in float32 at beam 5 on the lineage
    route and with ``use_lineage=False`` (the self cache gathered by beam
    every step, plain masked attention): tokens and lengths must be equal.
    bf16 is not used here: its sums in another order may flip ties."""
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.data.features import extract_features
    from speech_tranformer_pytorch_tpu_torch.decoding import beam_decode
    from speech_tranformer_pytorch_tpu_torch.profile_decode import DECODE
    from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer

    cfg = get_config("base", **{"model.dtype": "float32",
                                "features.output_dtype": "float32"})
    rec = Recognizer(cfg, params, device=dev)
    feats, flens = extract_features(audio, lens, cfg.features, device=dev)
    out = {}
    for use_lineage in (True, False):
        t0 = time.perf_counter()
        r = beam_decode(rec.model, feats, flens, **DECODE, use_lineage=use_lineage,
                        device=dev)
        torch.cuda.synchronize()
        out[use_lineage] = (r, time.perf_counter() - t0)
    (lin, lin_s), (gat, gat_s) = out[True], out[False]
    equal = (bool(torch.equal(lin.tokens, gat.tokens))
             and bool(torch.equal(lin.lengths, gat.lengths)))
    report = {"tokens_equal": equal, "steps": [lin.steps, gat.steps],
              "score_err": float((lin.scores - gat.scores).abs().max()),
              "wall_s_lineage": lin_s, "wall_s_gathered": gat_s}
    emit({"gathered_cache_f32": report})
    if not equal:
        raise AssertionError(f"use_lineage=False decodes other tokens: {report}")


def export_path(torch, dev):
    """The ``base`` recognizer exported for serving (``serving.py``) at beam
    5 and greedily, max_len 100, for ``smoke_batch``'s 8 utterances (features
    computed outside the timed calls): each artifact through bytes and
    ``load_exported``, its tokens and lengths equal to the live
    ``beam_decode``/``greedy_decode`` of the same model (early stop on),
    scores within 1e-5, and its launches exactly
    ``expected_serve_launches`` of 100 steps without the fbank. Prints the
    export seconds, the artifact's bytes and the median of 3 calls of the
    artifact and of the live decode (before any export in this process and
    after each)."""
    from speech_tranformer_pytorch_tpu_torch.data.features import extract_features
    from speech_tranformer_pytorch_tpu_torch.decoding import beam_decode, greedy_decode
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.profile_decode import DECODE, smoke_batch
    from speech_tranformer_pytorch_tpu_torch.serving import (export_recognizer,
                                                             flatten_params, load_exported)

    cfg, params, rec, audio, lens = smoke_batch(dev)
    max_len = DECODE["max_len"]
    feats, flens = extract_features(audio, lens, cfg.features, device=dev)
    flat = [x.to(dev) for x in flatten_params(params)]
    args = (flat, feats.float(), flens.to(torch.int32))
    total, report = {}, {}

    def walls(fn, n=3):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    def live_fn(beam):
        if beam > 1:
            return lambda: beam_decode(rec.model, feats, flens, beam_size=beam,
                                       max_len=max_len, alpha=DECODE["alpha"], device=dev)
        return lambda: greedy_decode(rec.model, feats, flens, max_len=max_len, device=dev)

    modes = (("beam5", DECODE["beam_size"]), ("greedy", 1))
    live = {}
    for name, beam in modes:   # the live decodes, before any export in this process
        live[name] = live_fn(beam)()
        live[name + "_wall_s"] = statistics.median(walls(live_fn(beam)))
    for name, beam in modes:
        t0 = time.perf_counter()
        data = export_recognizer(cfg, params, batch_size=feats.shape[0],
                                 frames=feats.shape[1], beam_size=beam, max_len=max_len,
                                 alpha=DECODE["alpha"], device=dev)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fn = load_exported(data)
        load_s = time.perf_counter() - t0
        fn(*args)                                   # first call
        torch.cuda.synchronize()
        interface.reset_launch_counts()
        tokens, lengths, scores = fn(*args)
        torch.cuda.synchronize()
        counts = interface.launch_counts()
        want = dict(expected_serve_launches(cfg, max_len, False, beam), stft_mel=0)
        if counts != want:
            raise AssertionError(f"{name} artifact launches {counts}, expected {want}")
        ref = live[name]
        live_tokens = ref.tokens if beam > 1 else ref.tokens[:, None]
        live_lens = ref.lengths if beam > 1 else ref.lengths[:, None]
        shape = (feats.shape[0], beam, max_len)
        if tuple(tokens.shape) != shape or tokens.dtype != torch.int32:
            raise AssertionError(f"{name} artifact tokens {tokens.dtype} "
                                 f"{tuple(tokens.shape)}, expected int32 {shape}")
        equal = (bool(torch.equal(tokens, live_tokens))
                 and bool(torch.equal(lengths, live_lens)))
        score_err = (float((scores - ref.scores).abs().max()) if beam > 1
                     else float(scores.abs().max()))
        report[name] = {
            "export_s": export_s, "load_s": load_s, "artifact_bytes": len(data),
            "tokens_equal": equal, "score_err": score_err, "live_steps": ref.steps,
            "artifact_wall_s": statistics.median(walls(lambda: fn(*args))),
            "live_wall_s_before_export": live[name + "_wall_s"],
            "live_wall_s": statistics.median(walls(live_fn(beam))),
            "launches": counts}
        emit({"export_path": {name: report[name]}})
        if not equal or not score_err <= 1e-5:
            raise AssertionError(f"{name} artifact differs from the live decode: "
                                 f"{report[name]}")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    return total


# ---------------------------------------------------------------------------
# Serving and training from files.

MANIFEST_STEPS, MANIFEST_CKPT_EVERY = 6, 3
# (name, int8, beam, checkpoint directory under the straight run's work dir)
MANIFEST_DECODES = (("beam5", False, 5, "checkpoints"), ("greedy", False, 1, "best"),
                    ("int8_beam5", True, 5, "checkpoints"))


def _write_corpus(root, vocab_size):
    """24 seeded int16 utterances of 4-6 s with 10-30 random tokens: 16 WAV
    files for the train manifest, 8 FLAC files for the test manifest."""
    import numpy as np

    from speech_tranformer_pytorch_tpu_torch.data.flac import write_flac
    from speech_tranformer_pytorch_tpu_torch.data.prepare import write_manifest, write_wav
    from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances

    audio, lens = make_utterances(24, min_seconds=4.0, max_seconds=6.0, seed=3)
    rng = np.random.default_rng(4)
    splits = {"train": [], "test": []}
    for i, n in enumerate(lens):
        pcm = audio[i, :n]
        if i < 16:
            path = f"{root}/u{i:02d}.wav"
            write_wav(path, pcm / 32768.0)
        else:
            path = f"{root}/u{i:02d}.flac"
            write_flac(path, pcm.astype(np.int32), 16000)
        tokens = rng.integers(4, vocab_size, size=int(rng.integers(10, 31))).tolist()
        splits["train" if i < 16 else "test"].append(
            {"utt_id": f"u{i:02d}", "audio": path, "num_samples": int(n),
             "sample_rate": 16000, "text": "", "tokens": tokens})
    paths = {}
    for split, entries in splits.items():
        paths[split] = f"{root}/{split}.jsonl"
        write_manifest(paths[split], entries)
    return paths


def _launch_delta(before, after):
    return {k: after[k] - before[k] for k in after}


def _add(total, delta):
    for k, v in delta.items():
        total[k] = total.get(k, 0) + v


def _count_dev_eval(tr, total):
    """Make ``tr``'s dev loss step and greedy dev decode check their exact
    launches (adding them to ``total``): per dev batch, the loss takes 1
    fbank and a flash forward per attention layer; the greedy decode 1
    fbank, a flash forward per encoder layer and a lineage launch per
    decoder layer and step. Each decode's steps go to
    ``tr.dev_decode_steps``."""
    from speech_tranformer_pytorch_tpu_torch import runner
    from speech_tranformer_pytorch_tpu_torch.kernels import interface

    m, steps = tr.cfg.model, []
    tr.dev_decode_steps = steps
    eval_fn, greedy_batch, real_decode = tr.eval_fn, tr._greedy_batch, runner.greedy_decode

    def greedy_decode(*args, **kwargs):
        out = real_decode(*args, **kwargs)
        steps.append(out.steps)
        return out

    def decode_batch(*args):
        runner.greedy_decode = greedy_decode
        try:
            return greedy_batch(*args)
        finally:
            runner.greedy_decode = real_decode

    def counted(name, fn, want_of):
        def call(*args):
            before = interface.launch_counts()
            out = fn(*args)
            delta = _launch_delta(before, interface.launch_counts())
            want = dict({k: 0 for k in delta}, **want_of())
            if delta != want:
                raise AssertionError(f"dev {name}: launches {delta}, expected {want}")
            _add(total, delta)
            return out
        return call

    tr.eval_fn = counted("loss", eval_fn, lambda: {
        "stft_mel": 1, "flash_fwd": m.num_encoder_layers + 2 * m.num_decoder_layers})
    tr._greedy_batch = counted("greedy decode", decode_batch, lambda: {
        "stft_mel": 1, "flash_fwd": m.num_encoder_layers,
        "lineage_attention": m.num_decoder_layers * steps[-1],
        "cross_attention_decode": m.num_decoder_layers * steps[-1]})


def _trainer_run(torch, dev, cfg, work, paths, max_steps, total, resume=False,
                 save=True, dev_manifest=None, mesh="auto", hashes=None):
    """A ``Trainer`` run to ``max_steps`` whose step function checks each
    step's exact launches (adding them to ``total``); returns the trainer
    and its steps per second from the first step's start to the last step's
    end (the device synchronized only after the last step). ``save=False``
    skips its checkpoint writes, so the time is the loop's alone. With
    ``dev_manifest`` the dev evaluations run too (``_count_dev_eval``).
    ``tr.step_starts`` holds the host clock at each step's start (from the
    train call's start). With a list ``hashes`` each host batch the train
    pipeline yields is hashed into it (``_batch_hash``) as it is made,
    before the ``Trainer`` pins and copies it."""
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.runner import Trainer

    tr = Trainer(cfg, work_dir=work, train_manifest=paths["train"],
                 dev_manifest=dev_manifest, resume=resume, device=dev, mesh=mesh)
    if dev_manifest:
        _count_dev_eval(tr, total)
    if hashes is not None:
        epoch_of = tr.batcher.epoch

        def hashed(*args, **kwargs):
            it = epoch_of(*args, **kwargs)
            try:
                for abatch in it:
                    hashes.append(_batch_hash(abatch))
                    yield abatch
            finally:
                it.close()

        tr.batcher.epoch = hashed
    inner, clock = tr.step_fn, {}
    tr.step_starts = starts = []
    want = step_launches(cfg, master=cfg.train.master_weights)

    def step(state, abatch, seed):
        starts.append(time.perf_counter())
        clock.setdefault("t0", starts[-1])
        before = interface.launch_counts()
        state, m = inner(state, abatch, seed)
        delta = _launch_delta(before, interface.launch_counts())
        if delta != want:
            raise AssertionError(f"Trainer step {state.step}: launches {delta}, "
                                 f"expected {want}")
        _add(total, delta)
        if state.step == max_steps:
            torch.cuda.synchronize()
            clock["t1"] = time.perf_counter()
        return state, m

    tr.step_fn = step
    if not save:
        tr.ckpt.save = lambda *a, **kw: False
    first = tr.state.step
    starts.append(time.perf_counter())
    tr.train(max_steps=max_steps)
    starts.append(clock["t1"])
    return tr, (max_steps - first) / (clock["t1"] - clock["t0"])


def _check_dev_eval(torch, tr, work, total):
    """The straight run's dev evaluations: the last logged dev loss equals
    the bare eval step's over the dev batches at the final weights (within
    1e-5 relative: the same kernels on the same inputs), its greedy CER is
    finite, and ``work/best`` holds the step of the best dev loss."""
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.runner import make_audio_eval_step
    from speech_tranformer_pytorch_tpu_torch.utils.checkpoint import Checkpointer

    with open(f"{work}/train_metrics.jsonl") as f:
        devs = [r for r in map(json.loads, f) if "dev_loss" in r]
    eval_step = make_audio_eval_step(tr.cfg)
    loss = tokens = 0.0
    for abatch in tr.dev_batcher.epoch(0):
        before = interface.launch_counts()
        m = eval_step(tr.state, abatch)
        _add(total, _launch_delta(before, interface.launch_counts()))
        n = float(m["tokens"])
        loss, tokens = loss + float(m["loss"]) * n, tokens + n
    bare = loss / tokens
    last = devs[-1] if devs else {}
    report = {"dev_evals_at_steps": [r["step"] for r in devs],
              "dev_loss": last.get("dev_loss"), "bare_eval_loss": bare,
              "dev_loss_rel_diff": abs(last.get("dev_loss", math.inf) - bare) / bare,
              "dev_cer": last.get("dev_cer"), "greedy_steps": tr.dev_decode_steps,
              "best_dev_step": tr.best_dev_step,
              "best_saved_step": Checkpointer(f"{work}/best").latest_step()}
    if not (last.get("step") == tr.state.step and report["dev_loss_rel_diff"] <= 1e-5
            and math.isfinite(last.get("dev_cer", math.nan)) and tr.best_dev_step > 0
            and report["best_saved_step"] == tr.best_dev_step):
        raise AssertionError(f"Trainer dev evaluation: {report}")
    return report


def _leaf_diffs(torch, a, b):
    """Per leaf: (max |a - b|, that over the leaf's largest |a|)."""
    out = {}
    for k, x in a.items():
        d = float((x.float() - b[k].float()).abs().max())
        out[k] = (d, d / max(float(x.float().abs().max()), 1e-30))
    return out


def _int8_shapes_checked(cfg, audio_shape, beam):
    """A served batch's int8 products (B·beam rows in each decode step,
    B·T' rows in init_cache's cross K/V) are among the checked shapes."""
    import torch

    from speech_tranformer_pytorch_tpu_torch.data.pipeline import _frames_for_samples
    from speech_tranformer_pytorch_tpu_torch.models.modules import subsampled_lengths

    m, (b, samples) = cfg.model, audio_shape
    t_sub = int(subsampled_lengths(torch.tensor([_frames_for_samples(samples, cfg.features)]))[0])
    d, rows = m.d_model, b * beam
    mm = {(rows, d, 3 * d if m.fused_qkv else d), (rows, d, d), (b * t_sub, d, d)}
    ffn = {(rows, d, m.d_ff, d)}
    if not (mm <= set(INT8_MATMUL_SHAPES) and ffn <= set(INT8_FFN_SHAPES)):
        raise AssertionError(f"int8 shapes {sorted(mm)} {sorted(ffn)} not all checked")


def manifest_path(torch, dev):
    """The base preset from files: a ``Trainer`` on a WAV manifest (straight,
    with dev evaluations on the FLAC test manifest; and stopped at step 3
    then resumed), then ``load_recognizer`` and ``decode_manifest`` of the
    FLAC manifest at beam 5, greedily (from ``work_dir/best``) and with
    int8 weights and cross-K/V cache, with exact launches per step and per
    batch; the hypotheses equal ``decode_batch`` on the same batches."""
    import tempfile

    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.data.pipeline import (
        BucketedBatcher, ManifestDataset, make_audio_train_step)
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.profile_decode import INT8
    from speech_tranformer_pytorch_tpu_torch.recognize import load_recognizer
    from speech_tranformer_pytorch_tpu_torch.train import create_train_state

    cfg = get_config("base", **{"train.batch_size": 8, "train.num_epochs": 100,
                                "train.log_every": 3, "train.eval_every_steps": 3,
                                "train.checkpoint_every_steps": MANIFEST_CKPT_EVERY})
    total, report = {k: 0 for k in interface.launch_counts()}, {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = _write_corpus(tmp, cfg.model.vocab_size)
        straight, _ = _trainer_run(torch, dev, cfg, f"{tmp}/a", paths, MANIFEST_STEPS,
                                   total, dev_manifest=paths["test"])
        report["dev_eval"] = _check_dev_eval(torch, straight, f"{tmp}/a", total)
        # The same batches through the bare step, then a second straight run
        # timed the same way (both warm), then the stopped-and-resumed run.
        batches, epoch = [], 0
        while len(batches) < MANIFEST_STEPS:
            batches += list(straight.batcher.epoch(epoch))
            epoch += 1
        batches = [b.to(dev) for b in batches[:MANIFEST_STEPS]]
        state = create_train_state(cfg, device=dev, seed=cfg.train.seed)
        bare_step = make_audio_train_step(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            before = interface.launch_counts()
            state, _ = bare_step(state, b, straight.dropout_seed)
            _add(total, _launch_delta(before, interface.launch_counts()))
        torch.cuda.synchronize()
        bare_sps = MANIFEST_STEPS / (time.perf_counter() - t0)
        del state, batches
        quiet = cfg.replace(train=cfg.train.replace(log_every=100))
        again, trainer_sps = _trainer_run(torch, dev, quiet, f"{tmp}/c", paths,
                                          MANIFEST_STEPS, total, save=False)
        _trainer_run(torch, dev, cfg, f"{tmp}/b", paths, MANIFEST_CKPT_EVERY, total)
        resumed, _ = _trainer_run(torch, dev, cfg, f"{tmp}/b", paths, MANIFEST_STEPS,
                                  total, resume=True)
        ref = straight.state.model.state_dict()
        resume_diff = _leaf_diffs(torch, ref, resumed.state.model.state_dict())
        rerun_diff = _leaf_diffs(torch, ref, again.state.model.state_dict())
        moment_diff = {m: _leaf_diffs(torch, getattr(straight.state.opt, m),
                                      getattr(resumed.state.opt, m)) for m in ("mu", "nu")}
        exact = all(d == 0.0 for d, _ in resume_diff.values()) and all(
            d == 0.0 for md in moment_diff.values() for d, _ in md.values())
        worst = max(resume_diff.items(), key=lambda kv: kv[1][1])
        report["train"] = {
            "steps": MANIFEST_STEPS, "batch": cfg.train.batch_size,
            "trainer_steps_per_s": trainer_sps, "bare_steps_per_s": bare_sps,
            "trainer_over_bare": trainer_sps / bare_sps,
            "resume_bit_identical": exact,
            "resume_param_max_abs_diff": max(d for d, _ in resume_diff.values()),
            "resume_worst_leaf": [worst[0], *worst[1]],
            "rerun_bit_identical": all(d == 0.0 for d, _ in rerun_diff.values()),
            "rerun_param_max_abs_diff": max(d for d, _ in rerun_diff.values()),
            "launches_per_step": step_launches(cfg, master=False)}
        del again, resumed
        if not exact and worst[1][1] > 1e-5:
            raise AssertionError(f"resumed params differ from the straight run's: "
                                 f"{report['train']}")

        ds = ManifestDataset(paths["test"], cfg.data, cfg.features)
        batcher = BucketedBatcher(
            ds, batch_size=4, bucket_boundaries=cfg.data.bucket_boundaries,
            target_len=min(cfg.data.max_target_len, cfg.model.max_target_positions),
            shuffle=False, drop_remainder=False,
            adaptive_target_len=cfg.data.adaptive_target_len)
        audio_s = sum(e["num_samples"] for e in ds.entries) / cfg.features.sample_rate
        for name, int8, beam, ckpt in MANIFEST_DECODES:
            dcfg = cfg.replace(decode=cfg.decode.replace(
                **{k.split(".")[1]: v for k, v in INT8.items()})) if int8 else cfg
            rec = load_recognizer(dcfg, f"{tmp}/a/{ckpt}", device=dev)
            inner, calls = rec.decode_batch, []

            def counted(audio, lens, *, beam_size, max_len, alpha, rec=rec, inner=inner,
                        calls=calls, dcfg=dcfg, int8=int8):
                if int8:
                    _int8_shapes_checked(dcfg, audio.shape, beam_size)
                before = interface.launch_counts()
                hyps = inner(audio, lens, beam_size=beam_size, max_len=max_len, alpha=alpha)
                delta = _launch_delta(before, interface.launch_counts())
                want = expected_serve_launches(dcfg, rec.last_steps, int8, beam_size)
                if rec.last_steps <= 0 or delta != want:
                    raise AssertionError(f"{name}: batch launches {delta}, expected {want}")
                _add(total, delta)
                calls.append(rec.last_steps)
                return hyps

            rec.decode_batch = counted
            out = f"{tmp}/{name}.jsonl"
            scores = rec.decode_manifest(paths["test"], beam_size=beam, batch_size=4,
                                         out_path=out)
            rec.decode_batch = inner
            with open(out) as f:
                served = {r["utt_id"]: r["tokens"] for r in map(json.loads, f)}
            direct = {}
            for abatch, rows in batcher.epoch(0, with_rows=True):
                hyps = inner(abatch.audio, abatch.sample_lens, beam_size=beam,
                             max_len=dcfg.decode.max_decode_len,
                             alpha=dcfg.decode.length_penalty)
                direct.update({ds.entries[i]["utt_id"]: h for i, h in zip(rows, hyps)})
            if served != direct:
                raise AssertionError(f"{name}: decode_manifest and decode_batch differ")
            if not (scores["utterances"] == len(ds) and math.isfinite(scores["cer"])
                    and abs(scores["audio_seconds"] - audio_s) < 1e-9
                    and scores["rtf"] > 0 and scores["rtf_with_compile"] > 0):
                raise AssertionError(f"{name}: scores {scores}")
            report[name] = {**scores, "batch_decode_steps": calls,
                            "hyps_equal_decode_batch": True}
            del rec
    emit({"manifest_path": report})
    return total


# The input pipelines on a FLAC corpus (``pipeline_path``).

PIPELINE_FILES, PIPELINE_REPEATS = 64, 14    # unique FLAC files; manifest entries of each
PIPELINE_STEPS, PIPELINE_STOP = 8, 4          # pipelines compared; the resumed run's stop
PIPELINE_WALL_STEPS = 24                      # steps of each timed run
PIPELINE_WORKERS = (2, 4, 8)                 # the JAX default, to the card host's 8 cores
PIPELINE_PY_DECODES = 4                      # files decoded by the pure-Python decoder
PIPELINE_DEV = 8                             # files of the dev manifest decode_manifest serves


def _batch_hash(abatch) -> str:
    """sha256 over a host ``AudioBatch``'s arrays (dtype, shape and bytes)."""
    import hashlib

    h = hashlib.sha256()
    for f in FIELDS:
        x = getattr(abatch, f).numpy()
        h.update(f"{f}{x.dtype}{x.shape}".encode())
        h.update(x.tobytes())
    return h.hexdigest()


def _write_flac_file(args):
    """One corpus file (a process pool's task): write, then return the PCM
    the file must decode to."""
    import numpy as np

    from speech_tranformer_pytorch_tpu_torch.data.flac import write_flac

    path, pcm = args
    write_flac(path, pcm.astype(np.int32), 16000)
    return path


def _write_flac_corpus(root, vocab_size):
    """``PIPELINE_FILES`` seeded int16 utterances of 8-12 s as FLAC files,
    written by a process pool; a train manifest that lists each file
    ``PIPELINE_REPEATS`` times with tokens of its own (every entry is read
    and decoded), and a dev manifest of the first ``PIPELINE_DEV`` files.
    Returns (manifest paths, {path: PCM})."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from speech_tranformer_pytorch_tpu_torch.data.prepare import write_manifest
    from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances

    audio, lens = make_utterances(PIPELINE_FILES, min_seconds=8.0, max_seconds=12.0, seed=5)
    pcm = {f"{root}/p{i:02d}.flac": audio[i, :n].copy() for i, n in enumerate(lens)}
    with ProcessPoolExecutor(min(os.cpu_count() or 1, 8),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        list(pool.map(_write_flac_file, pcm.items()))
    rng = np.random.default_rng(6)
    entry = lambda uid, path: {
        "utt_id": uid, "audio": path, "num_samples": len(pcm[path]), "sample_rate": 16000,
        "text": "", "tokens": rng.integers(4, vocab_size, size=int(rng.integers(10, 31))).tolist()}
    files = sorted(pcm)
    manifests = {"train": [entry(f"r{r}_{i:02d}", p) for r in range(PIPELINE_REPEATS)
                           for i, p in enumerate(files)],
                 "dev": [entry(f"d{i:02d}", p) for i, p in enumerate(files[:PIPELINE_DEV])]}
    paths = {}
    for split, entries in manifests.items():
        paths[split] = f"{root}/{split}.jsonl"
        write_manifest(paths[split], entries)
    return paths, pcm


def _decode_rates(pcm):
    """Native decode of every file (equal to its PCM), the pure-Python
    decoder on the first ``PIPELINE_PY_DECODES`` (bit-equal to native);
    each route's median ms per audio second."""
    import numpy as np

    from speech_tranformer_pytorch_tpu_torch.data.flac import decode_flac

    rates = {"native": [], "python": []}
    for i, (path, want) in enumerate(sorted(pcm.items())):
        t0 = time.perf_counter()
        got, rate, bps = decode_flac(path)
        rates["native"].append((time.perf_counter() - t0) * 1e3 / (len(want) / 16000))
        if not ((rate, bps) == (16000, 16) and np.array_equal(got[:, 0], want)):
            raise AssertionError(f"{path}: native decode differs from the PCM written")
        if i < PIPELINE_PY_DECODES:
            t0 = time.perf_counter()
            plain = decode_flac(path, force_python=True)
            rates["python"].append((time.perf_counter() - t0) * 1e3 / (len(want) / 16000))
            if not (np.array_equal(plain[0], got) and plain[1:] == (rate, bps)):
                raise AssertionError(f"{path}: native decode differs from force_python")
    return {k: {"median_ms_per_audio_s": statistics.median(v), "files": len(v)}
            for k, v in rates.items()}


def _step_walls(starts, workers: int = 0):
    """From ``step_starts``: seconds to the first step, the median step
    wall, and that median over the steps after each of ``workers`` workers
    has delivered its first batch (in plan order, batch i comes from worker
    i mod ``workers``, so the first ``workers`` steps wait on start-ups)."""
    walls = [b - a for a, b in zip(starts[1:-1], starts[2:])]
    return {"first_step_after_s": starts[1] - starts[0],
            "median_step_s": statistics.median(walls),
            "steady_median_step_s": statistics.median(walls[workers:]),
            "steps": len(walls)}


def _pipeline_cer(torch, dev, cfg, paths, tmp, total):
    """``load_recognizer`` + ``decode_manifest`` of the FLAC dev manifest at
    beam 5 with exact launches per batch; its ``cer`` (native) equals
    ``cer(force_python=True)`` over the hypotheses it wrote."""
    from speech_tranformer_pytorch_tpu_torch.data.prepare import read_manifest
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.ops.metrics import cer
    from speech_tranformer_pytorch_tpu_torch.recognize import load_recognizer

    rec = load_recognizer(cfg, f"{tmp}/grain/checkpoints", device=dev)
    inner, steps = rec.decode_batch, []

    def counted(audio, lens, *, beam_size, max_len, alpha):
        before = interface.launch_counts()
        hyps = inner(audio, lens, beam_size=beam_size, max_len=max_len, alpha=alpha)
        delta = _launch_delta(before, interface.launch_counts())
        want = expected_serve_launches(cfg, rec.last_steps, False, beam_size)
        if rec.last_steps <= 0 or delta != want:
            raise AssertionError(f"pipeline decode: launches {delta}, expected {want}")
        _add(total, delta)
        steps.append(rec.last_steps)
        return hyps

    rec.decode_batch = counted
    out = f"{tmp}/dev_hyps.jsonl"
    scores = rec.decode_manifest(paths["dev"], beam_size=5, batch_size=4, out_path=out)
    with open(out) as f:
        hyps = {r["utt_id"]: r["tokens"] for r in map(json.loads, f)}
    refs = {e["utt_id"]: e["tokens"] for e in read_manifest(paths["dev"])}
    plain = cer([refs[u] for u in sorted(refs)], [hyps[u] for u in sorted(refs)],
                force_python=True)
    if not (len(hyps) == PIPELINE_DEV and plain["cer"] == scores["cer"]
            and plain["errors"] == scores["errors"]):
        raise AssertionError(f"pipeline decode: cer {scores} against plain {plain}")
    return {"cer": scores["cer"], "cer_force_python": plain["cer"],
            "errors": scores["errors"], "rtf": scores["rtf"], "batch_decode_steps": steps}


def pipeline_path(torch, dev):
    """The ``base`` preset's ``Trainer`` (full width and depth, batch 32) on
    a FLAC corpus of 8-12 s utterances with both input pipelines: native
    FLAC decoding against the pure-Python decoder and the PCM written;
    ``data.pipeline="grain"`` at 2 workers against ``"python"`` over
    ``PIPELINE_STEPS`` steps from one init (each step's host batch hashed
    equal, losses and parameters within 1e-5, exact launches a step); the
    grain run stopped at ``PIPELINE_STOP`` and resumed on the plan's
    batches; the median step wall with each pipeline (and 8 workers) over
    ``PIPELINE_WALL_STEPS`` steps against the bare step on one
    device-resident batch; then
    ``decode_manifest`` of a FLAC dev manifest at beam 5, its native CER
    equal to the plain one. Native calls are counted."""
    import tempfile

    from speech_tranformer_pytorch_tpu_torch import native
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.data.pipeline import make_audio_train_step
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.train import create_train_state

    card = smi_line()
    native.reset_call_counts()
    total, report = {k: 0 for k in interface.launch_counts()}, {}
    base = get_config("base", **{"train.batch_size": 32, "train.num_epochs": 1,
                                 "train.log_every": 1, "data.num_workers": 2,
                                 "train.checkpoint_every_steps": 100})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths, pcm = _write_flac_corpus(tmp, base.model.vocab_size)
        report["corpus"] = {"files": len(pcm), "write_s": time.perf_counter() - t0,
                            "audio_s": sum(len(x) for x in pcm.values()) / 16000,
                            "train_entries": PIPELINE_FILES * PIPELINE_REPEATS}
        report["decode"] = _decode_rates(pcm)
        n_batches = len(_train_batcher(base, paths).plan(0))
        if n_batches < PIPELINE_WALL_STEPS:
            raise AssertionError(f"pipeline_path: epoch 0 plans {n_batches} batches, "
                                 f"fewer than {PIPELINE_WALL_STEPS} steps")
        # Straight runs of both pipelines, then grain stopped and resumed.
        runs, hashes = {}, {}
        for name in ("python", "grain"):
            cfg = base.replace(data=base.data.replace(pipeline=name))
            hashes[name] = []
            runs[name], _ = _trainer_run(torch, dev, cfg, f"{tmp}/{name}", paths,
                                         PIPELINE_STEPS, total, hashes=hashes[name])
        grain = base.replace(data=base.data.replace(pipeline="grain"))
        resumed_hashes = []
        _trainer_run(torch, dev, grain, f"{tmp}/resumed", paths, PIPELINE_STOP, total)
        resumed, _ = _trainer_run(torch, dev, grain, f"{tmp}/resumed", paths,
                                  PIPELINE_STEPS, total, resume=True, hashes=resumed_hashes)
        losses = {}
        for name in ("python", "grain"):
            with open(f"{tmp}/{name}/train_metrics.jsonl") as f:
                losses[name] = [r["loss"] for r in map(json.loads, f) if "loss" in r]
        params = _leaf_diffs(torch, runs["python"].state.model.state_dict(),
                             runs["grain"].state.model.state_dict())
        resumed_params = _leaf_diffs(torch, runs["grain"].state.model.state_dict(),
                                     resumed.state.model.state_dict())
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["grain"], losses["python"]))
        report["pipelines"] = {
            "epoch_batches": n_batches, "steps": PIPELINE_STEPS,
            "batches_equal": hashes["grain"][:PIPELINE_STEPS] == hashes["python"][:PIPELINE_STEPS],
            "losses_python": losses["python"], "losses_grain": losses["grain"],
            "loss_max_rel_diff": loss_rel,
            "param_worst_rel_diff": max(r for _, r in params.values()),
            "resume_start": [resumed.start_epoch, resumed.start_batch],
            "resume_batches_equal": (resumed_hashes[:PIPELINE_STEPS - PIPELINE_STOP]
                                     == hashes["grain"][PIPELINE_STOP:PIPELINE_STEPS]),
            "resume_param_worst_rel_diff": max(r for _, r in resumed_params.values()),
            "launches_per_step": step_launches(base, master=False)}
        p = report["pipelines"]
        if not (p["batches_equal"]
                and len(hashes["python"]) >= PIPELINE_STEPS
                and len(losses["python"]) == len(losses["grain"]) == PIPELINE_STEPS
                and loss_rel <= 1e-5 and p["param_worst_rel_diff"] <= 1e-5
                and p["resume_start"] == [0, PIPELINE_STOP] and p["resume_batches_equal"]
                and p["resume_param_worst_rel_diff"] <= 1e-5):
            raise AssertionError(f"pipeline_path: {p}")
        del runs, resumed
        # Walls: each pipeline without logging or saves, then the bare step.
        quiet = base.replace(train=base.train.replace(log_every=100))
        walls = {}
        for name, workers in (("python", 0), *(("grain", w) for w in PIPELINE_WORKERS)):
            cfg = quiet.replace(data=quiet.data.replace(pipeline=name, num_workers=workers))
            tag = name if name == "python" else f"grain_{workers}_workers"
            tr, sps = _trainer_run(torch, dev, cfg, f"{tmp}/wall_{tag}", paths,
                                   PIPELINE_WALL_STEPS, total, save=False)
            walls[f"trainer_{tag}"] = {**_step_walls(tr.step_starts, workers),
                                       "steps_per_s": sps}
            del tr
        abatch = _first_batch(quiet, paths).to(dev)
        state = create_train_state(quiet, device=dev, seed=quiet.train.seed)
        bare, starts = make_audio_train_step(quiet), [time.perf_counter()]
        for _ in range(PIPELINE_WALL_STEPS):
            starts.append(time.perf_counter())
            before = interface.launch_counts()
            state, _ = bare(state, abatch, quiet.train.seed + 1)
            _add(total, _launch_delta(before, interface.launch_counts()))
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        walls["bare_step"] = _step_walls(starts)
        del state, abatch
        report["walls"] = walls
        report["dev_decode"] = _pipeline_cer(torch, dev, base, paths, tmp, total)
    report["native_calls"] = native.call_counts()
    if not (report["native_calls"]["flac_decode"] > 0
            and report["native_calls"]["edit_distance_corpus_i32"] > 0):
        raise AssertionError(f"native libraries not called: {report['native_calls']}")
    emit({"pipeline_path": report})
    for what, wall in report["walls"].items():
        print(card, flush=True)
        emit({"pipeline_wall": {what: wall, "card": card}})
    for route, rate in report["decode"].items():
        emit({"flac_decode_rate": {route: rate, "card": card}})
    return total


def _train_batcher(cfg, paths):
    """The ``Trainer``'s batcher of the train manifest (the Python pipeline)."""
    from speech_tranformer_pytorch_tpu_torch.data.pipeline import BucketedBatcher, ManifestDataset

    ds = ManifestDataset(paths["train"], cfg.data, cfg.features)
    return BucketedBatcher(ds, batch_size=cfg.train.batch_size,
                           bucket_boundaries=cfg.data.bucket_boundaries,
                           target_len=min(cfg.data.max_target_len,
                                          cfg.model.max_target_positions),
                           seed=cfg.train.seed, drop_remainder=True,
                           adaptive_target_len=cfg.data.adaptive_target_len)


def _first_batch(cfg, paths):
    """The first planned train batch of epoch 0 (host tensors)."""
    return next(_train_batcher(cfg, paths).epoch(0))


RECIPE_STEPS = 400
# The overfit anchor's model (tiny preset, d_model 128, 2+2 layers, dropout 0)
# on its 10 synthetic utterances, all in each batch.
RECIPE_SETS = {"model.d_model": 128, "model.num_heads": 4, "model.d_ff": 256,
               "model.num_encoder_layers": 2, "model.num_decoder_layers": 2,
               "model.dropout_rate": 0.0, "model.subsample_channels": 16,
               "train.batch_size": 10, "train.num_epochs": RECIPE_STEPS,
               "train.log_every": 50}
_CLI_BOOT = ("import json, runpy, sys\n"
             "from speech_tranformer_pytorch_tpu_torch.kernels import interface\n"
             "sys.argv = sys.argv[1:]\n"
             "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n"
             "print('LAUNCHES ' + json.dumps(interface.launch_counts()), flush=True)\n")


def run_cli(cli, args):
    """``python -m <package>.<cli> args`` in a child process that prints its
    kernel launches last; returns (stdout lines before that, launches)."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", _CLI_BOOT, f"{PKG}.{cli}", *args],
                          cwd=root, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{cli} {args} failed ({proc.returncode}): "
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    if not lines or not lines[-1].startswith("LAUNCHES "):
        raise AssertionError(f"{cli}: no launch line in {lines[-5:]}")
    return lines[:-1], json.loads(lines[-1][len("LAUNCHES "):])


def _logged_losses(work):
    with open(f"{work}/train_metrics.jsonl") as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f) if "loss" in r}


def drive_recipe(torch, dev):
    """The user recipe through the port's CLIs as child processes on the
    card: prepare_cli synthetic -> train_cli (straight, and stopped halfway
    then --resume'd) -> recognize_cli on the train split, which must print
    ``"cer": 0.0``."""
    import tempfile

    from speech_tranformer_pytorch_tpu_torch.config import get_config

    per_step = step_launches(get_config("tiny", **RECIPE_SETS), master=False)
    total, report = {k: 0 for k in per_step}, {}
    with tempfile.TemporaryDirectory() as tmp:
        data = f"{tmp}/data"
        t0 = time.perf_counter()
        run_cli("prepare_cli", ["synthetic", "--out", data, "--num-train", "10",
                                "--num-dev", "0", "--num-test", "0", "--vocab-size", "32",
                                "--seed", "0", "--device", dev.type])
        common = ["--preset", "tiny", "--data-dir", data, "--device", dev.type]
        common += [a for k, v in RECIPE_SETS.items() for a in ("--set", f"{k}={v}")]
        runs = (("straight", "a", [], RECIPE_STEPS),
                ("first_half", "b", [], RECIPE_STEPS // 2),
                ("resumed", "b", ["--resume"], RECIPE_STEPS))
        done = 0
        for name, work, extra, steps in runs:
            t1 = time.perf_counter()
            _, launches = run_cli("train_cli", common + ["--work-dir", f"{tmp}/{work}",
                                                         "--max-steps", str(steps)] + extra)
            want = {k: v * (steps - done) for k, v in per_step.items()}
            done = steps if name == "first_half" else 0
            if launches != want:
                raise AssertionError(f"train_cli {name}: launches {launches}, "
                                     f"expected {want}")
            _add(total, launches)
            report[f"train_{name}_s"] = time.perf_counter() - t1
        la, lb = _logged_losses(f"{tmp}/a"), _logged_losses(f"{tmp}/b")
        report["logged_loss"] = {step: [la[step], lb.get(step)] for step in la}
        last = max(la)
        rel = abs(la[last] - lb.get(last, math.inf)) / abs(la[last])
        report["final_loss_rel_diff"] = rel
        if last != RECIPE_STEPS or rel > 1e-2:
            raise AssertionError(f"resumed recipe differs: {report}")
        t1 = time.perf_counter()
        lines, launches = run_cli("recognize_cli", ["--data-dir", data, "--work-dir",
                                                    f"{tmp}/a", "--split", "train",
                                                    "--device", dev.type])
        scores = json.loads(lines[-1])
        report["recognize_s"] = time.perf_counter() - t1
        report["recognize"] = scores
        # One batch of 10, decoded twice (its first call, then again for the
        # steady-state RTF): per call 1 fbank and 2 encoder flash launches;
        # per beam step 1 prune, 2 lineage and 2 cross-attention launches.
        calls = 2
        layer_steps = RECIPE_SETS["model.num_decoder_layers"] * launches["beam_prune"]
        want = dict({k: 0 for k in launches}, stft_mel=calls,
                    flash_fwd=RECIPE_SETS["model.num_encoder_layers"] * calls,
                    beam_prune=launches["beam_prune"], lineage_attention=layer_steps,
                    cross_attention_decode=layer_steps)
        if launches != want or launches["beam_prune"] < calls:
            raise AssertionError(f"recognize_cli launches {launches}, expected {want}")
        _add(total, launches)
        report["wall_s"] = time.perf_counter() - t0
        emit({"drive_recipe": report})
        if scores.get("cer") != 0.0 or scores.get("utterances") != 10.0:
            raise AssertionError(f"recognize_cli on the train split: {scores}")
    return total


# Ring attention's per-block route: FlashAttentionStats, the B-4 forward
# with its lse and the B-5/B-6 backward with di − dlse, merged by logaddexp
# (``parallel/ring_attention.flash_step``), at the ``sharded`` encoder
# shape: B 8, H 16, D 128, T' 748 in 4 key blocks of 187 (the whole of a
# 4-rank ring's work on one card: each rank takes a quarter of the query
# rows). Row 1 (length 300) keeps no key in blocks 2 and 3, so a whole
# empty block goes through the route with a nonzero lse cotangent. Held
# against the same route over the plain versions at check_flash's
# tolerances, bit-identical on a second call, and against one
# whole-sequence flash call: at the ring's tolerance (2e-4, JAX's ring
# against full attention) in float32 and at the bf16 flash tolerance in
# bf16 (each block's o is rounded to bf16 before the merge).
RING_SHAPE = (8, 16, 748, 128, 4)        # batch, heads, T', head_dim, ring size
RING_LENS = (748, 300, 700, 512, 655, 600, 433, 748)
RING_TOL = (2e-4, 2e-4)


def check_ring_blocks(torch, dev):
    from speech_tranformer_pytorch_tpu_torch.kernels import flash_attention as fa
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.parallel.ring_attention import (
        LSE_INIT, flash_step)

    b, h, t, d, n = RING_SHAPE
    blk = t // n
    lens = torch.tensor(RING_LENS, dtype=torch.int32, device=dev)
    block_lens = [torch.clamp(lens - j * blk, 0, blk) for j in range(n)]
    if int(block_lens[2][1]) or int(block_lens[3][1]):
        raise AssertionError("row 1 should keep no key in blocks 2 and 3")
    kernel = lambda q, k, v, l: fa.FlashAttentionStats.apply(q, k, v, l, False)
    plain = lambda q, k, v, l: fa.flash_fwd_reference(q, k, v, l, causal=False)

    def route(stats, q, k, v):
        carry = (torch.zeros((b, h, t, d), dtype=torch.float32, device=dev),
                 torch.full((b, h, t), LSE_INIT, device=dev))
        for j in range(n):
            sl = slice(j * blk, (j + 1) * blk)
            carry = flash_step(q, k[:, sl], v[:, sl], block_lens[j], carry, stats)
        return carry[0].transpose(1, 2).to(q.dtype)

    def fwd_bwd(fn, q, k, v, do):
        o = fn(q, k, v)
        return [o.detach()] + list(torch.autograd.grad(o, (q, k, v), do))

    whole = lambda q, k, v: interface.flash_attention(q, k, v, kv_lengths=lens,
                                                      causal=False)
    errs, timed = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        (fa_tol, fr_tol), (ga_tol, gr_tol) = FLASH_TOL[dname]
        g = torch.Generator(device=dev).manual_seed(17)
        q, k, v, do = (torch.randn(b, t, h, d, device=dev, generator=g).to(dtype)
                       for _ in range(4))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        got = fwd_bwd(lambda *a: route(kernel, *a), q, k, v, do)
        want = fwd_bwd(lambda *a: route(plain, *a), q, k, v, do)
        full = fwd_bwd(whole, q, k, v, do)
        torch.cuda.synchronize()
        tag = f"ring_blocks[{dname}]"
        e = {}
        for i, name in enumerate(("o", "dq", "dk", "dv")):
            if not bool(torch.isfinite(got[i]).all()):
                raise AssertionError(f"{tag}.{name}: non-finite")
            scale = float(want[i].float().abs().max()) or 1.0
            a_tol, r_tol = (fa_tol, fr_tol) if name == "o" else (ga_tol, gr_tol)
            e[name] = check_close(f"{tag}.{name}", got[i], want[i],
                                  a_tol * (scale if dname == "bfloat16" or name != "o"
                                           else 1.0), r_tol)
            w_a, w_r = RING_TOL if dname == "float32" else (a_tol, r_tol)
            e[f"{name}_vs_whole"] = check_close(f"{tag}.{name} vs whole", got[i], full[i],
                                                w_a * scale, w_r)
        again = fwd_bwd(lambda *a: route(kernel, *a), q, k, v, do)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{tag}: a second call gave other bits")
        e["bit_identical_on_second_call"] = True
        errs[dname] = e
        emit({"check": {"name": tag, "max_abs_err": e}})
        if dtype == torch.bfloat16:
            timed = dict(q=q, k=k, v=v, do=do, err=e)

    # Each kernel's time on the route: its n block calls, bf16, with the
    # inputs the route gives it (dlse from the merge folded into di).
    q, k, v, do = (x.detach() for x in (timed["q"], timed["k"], timed["v"], timed["do"]))
    qt, dot = q.transpose(1, 2), do.transpose(1, 2)
    blocks = []
    for j in range(n):
        sl = slice(j * blk, (j + 1) * blk)
        kt, vt = k[:, sl].transpose(1, 2), v[:, sl].transpose(1, 2)
        o_b, lse_b = fa.flash_fwd_cuda(qt, kt, vt, block_lens[j], causal=False)
        dlse = torch.randn(lse_b.shape, device=dev, generator=g)
        di = (o_b.float() * dot.float()).sum(-1) - dlse
        blocks.append((kt, vt, block_lens[j], lse_b, di))
    esz = q.element_size()
    io_q, io_k, stat = b * h * t * d * esz, b * h * blk * d * esz, b * h * t * 4

    def over_blocks(fn, reps=20, rounds=5):
        return device_ms(torch, lambda: [fn(*blk_) for blk_ in blocks], reps, rounds)

    pairs = h * t * int(lens.sum())            # kept (query, key) pairs, all blocks
    kinds = {
        "flash_fwd": (lambda kt, vt, l, lse, di: fa.flash_fwd_cuda(qt, kt, vt, l, causal=False),
                      lambda kt, vt, l, lse, di: fa.flash_fwd_reference(qt, kt, vt, l, causal=False),
                      n * (io_q + 2 * io_k + io_q + stat), 4 * d * pairs),
        "flash_bwd_dkv": (lambda kt, vt, l, lse, di: fa.flash_bwd_dkv_cuda(
                              qt, kt, vt, dot, lse, di, l, causal=False),
                          lambda kt, vt, l, lse, di: fa.flash_bwd_dkv_reference(
                              qt, kt, vt, dot, lse, di, l, causal=False),
                          n * (2 * io_q + 4 * io_k + 2 * stat), 8 * d * pairs),
        "flash_bwd_dq": (lambda kt, vt, l, lse, di: fa.flash_bwd_dq_cuda(
                             qt, kt, vt, dot, lse, di, l, causal=False),
                         lambda kt, vt, l, lse, di: fa.flash_bwd_dq_reference(
                             qt, kt, vt, dot, lse, di, l, causal=False),
                         n * (3 * io_q + 2 * io_k + 2 * stat), 6 * d * pairs),
    }
    out = {}
    for name, (kfn, pfn, nbytes, flops) in kinds.items():
        bound_ms, bound_by = bound(nbytes, flops, H100_BF16_FLOP_PER_S)
        out[name] = {"ms": over_blocks(kfn), "plain_ms": over_blocks(pfn, 3, 3),
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                     "library_note": "no PyTorch call returns the lse a block merge needs",
                     "blocks": n, "shape": [b, h, t, blk, d],
                     "max_abs_err": max(v_ for k_, v_ in timed["err"].items()
                                        if k_ in ("o", "dq", "dk", "dv"))}
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    routes = {
        "ring_route_fwd_bwd_ms": device_ms(torch, lambda: fwd_bwd(
            lambda *a: route(kernel, *a), qr, kr, vr, do), 5, 3),
        "plain_route_fwd_bwd_ms": device_ms(torch, lambda: fwd_bwd(
            lambda *a: route(plain, *a), qr, kr, vr, do), 2, 3),
        "whole_flash_fwd_bwd_ms": device_ms(torch, lambda: fwd_bwd(whole, qr, kr, vr, do), 5, 3),
    }
    emit({"check": {"name": "ring_block_timing", "shape": [b, h, t, d, n],
                    "lens": list(RING_LENS), **routes, **out}})
    return out


# The parallel path: one NCCL rank per card (``parallel.mesh.spawn_ranks``).
# The ``sharded`` preset at full width and depth (d_model 2048, 16 heads,
# d_ff 8192, 12+6 layers, remat, ring attention) on a (1, n) mesh trains 3
# steps on 16 int16 utterances of 20-30 s per data rank (20-60 tokens) with
# exact per-rank launches, its losses and grad norms held to the
# single-device step's on the same card and batch (bit-equal on one rank,
# 1e-3 relative over several); then sharded beam-5 and greedy decoding of 8 utterances of
# 4-6 s (max_len 100) with exact launches a batch, tokens equal to the
# single-device Recognizer's (on one rank in bf16; over several model
# ranks, whose bf16 partial sums round in another order, in float32);
# then ``base`` through ``Trainer(mesh=...)`` on a (n, 1) mesh of a WAV
# manifest, 4 steps straight (dev evaluations of the FLAC manifest at
# steps 2 and 4, exact launches a dev batch) and 2 + resumed to 4
# (bit-identical), then ``decode_manifest(distributed=True)`` of the FLAC
# manifest, the same scores on every rank. With one card every collective
# is real NCCL on one rank and the ring has one block.
PARALLEL_SECONDS, PARALLEL_TOKENS = (20.0, 30.0), (20, 60)
PARALLEL_UTTS, PARALLEL_STEPS, PARALLEL_TRAINER_STEPS = 16, 3, 4
FIELDS = ("audio", "sample_lens", "targets_in", "targets_out", "target_lens", "valid")


def _parallel_sharded(torch, dev, counts, report):
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.data.pipeline import (
        AudioBatch, make_audio_train_step)
    from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer
    from speech_tranformer_pytorch_tpu_torch.parallel.mesh import make_mesh
    from speech_tranformer_pytorch_tpu_torch.parallel.sharding import (
        data_rows, make_sharded_audio_train_step)
    from speech_tranformer_pytorch_tpu_torch.profile_decode import DECODE
    from speech_tranformer_pytorch_tpu_torch.profile_train import smoke_audio_batch
    from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer
    from speech_tranformer_pytorch_tpu_torch.train import create_train_state

    import torch.distributed as dist

    n = dist.get_world_size()
    cfg = get_config("sharded", **{"mesh.model_axis": n})
    mesh = make_mesh(cfg.mesh, device=dev)
    t0 = time.perf_counter()
    whole = SpeechTransformer(cfg.model).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    gbatch = smoke_audio_batch(cfg, PARALLEL_UTTS * mesh.dp, device="cpu",
                               seconds=PARALLEL_SECONDS, tokens=PARALLEL_TOKENS)
    local = AudioBatch(*(data_rows(getattr(gbatch, f), mesh) for f in FIELDS)).to(dev)
    state = create_train_state(cfg, params=whole, mesh=mesh)
    report["sharded_setup_s"] = time.perf_counter() - t0
    report["parameters"] = sum(v.numel() for v in whole.values())
    step = make_sharded_audio_train_step(cfg, mesh)
    want = step_launches(cfg, master=False, ring=mesh.tp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    interface.reset_launch_counts()
    state, walls, losses, m, norms = _checked_steps(
        torch, step, state, local, PARALLEL_STEPS, want, "sharded train")
    _add(counts, interface.launch_counts())
    wall = statistics.median(walls[1:])
    report["sharded_train"] = {
        "mesh": mesh.shape, "utterances_per_data_rank": int(local.audio.shape[0]),
        "steps": len(walls), "step_wall_s": walls, "step_wall_s_median": wall,
        "audio_s_per_step": float(m["audio_seconds"]),
        "audio_s_per_s": float(m["audio_seconds"]) / wall,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev), "loss": losses,
        "grad_norm": norms, "launches_per_step": want}
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"sharded train: non-finite loss {losses} or norm {norms}")
    del state, step
    torch.cuda.empty_cache()
    if mesh.is_main:      # the single-device step on the same card and batch
        single = create_train_state(cfg, device=dev, params=whole)
        sstep, slosses, snorms = make_audio_train_step(cfg), [], []
        gdev = gbatch.to(dev)
        for _ in range(PARALLEL_STEPS):
            single, sm = sstep(single, gdev)
            slosses.append(float(sm["loss"]))
            snorms.append(float(sm["grad_norm"]))
        rel = [abs(a - b_) / abs(b_) for a, b_ in zip(losses + norms, slosses + snorms)]
        report["sharded_train"].update(single_device_loss=slosses,
                                       single_device_grad_norm=snorms,
                                       loss_rel_diff=rel[:len(losses)],
                                       grad_norm_rel_diff=rel[len(losses):])
        # One rank runs the single-device program: the same bits. Over
        # several model ranks the bf16 partial sums add in another order.
        if (mesh.tp == 1 and (losses, norms) != (slosses, snorms)) or max(rel) > 1e-3:
            raise AssertionError(f"sharded losses {losses}, grad norms {norms} vs "
                                 f"single-device {slosses}, {snorms}")
        del single, sstep, gdev
        torch.cuda.empty_cache()

    audio, lens = make_utterances(8, min_seconds=4.0, max_seconds=6.0, seed=5)
    audio, lens = torch.from_numpy(audio), torch.from_numpy(lens)
    rec = Recognizer(cfg, whole, mesh=mesh)
    single_rec = Recognizer(cfg, whole, device=dev) if mesh.is_main else None
    report["sharded_decode"] = {}
    for beam in (DECODE["beam_size"], 1):
        decode = dict(DECODE, beam_size=beam)
        rec.decode_batch(audio, lens, **decode)            # the shape's first call
        torch.cuda.synchronize()
        interface.reset_launch_counts()
        t0 = time.perf_counter()
        hyps = rec.decode_batch(audio, lens, **decode)
        torch.cuda.synchronize()
        dwall = time.perf_counter() - t0
        got = interface.launch_counts()
        _add(counts, got)
        want = expected_serve_launches(cfg, rec.last_steps, False, beam, ring=mesh.tp)
        if rec.last_steps <= 0 or got != want:
            raise AssertionError(f"sharded decode beam {beam}: launches {got}, "
                                 f"expected {want}")
        entry = {"wall_s": dwall, "decode_steps": rec.last_steps, "launches": got,
                 "hyp_lens": [len(x) for x in hyps]}
        if single_rec is not None:
            shyps = single_rec.decode_batch(audio, lens, **decode)
            entry["hyps_equal_single_device"] = sum(a == b_ for a, b_ in zip(hyps, shyps))
            # One rank: the same kernels on the same inputs, so the same
            # bits. Over several model ranks the bf16 partial sums round in
            # another order, so ties may break otherwise: there the
            # float32 decode below must match.
            if mesh.tp == 1 and shyps != hyps:
                raise AssertionError(f"sharded decode beam {beam}: tokens differ from "
                                     "the single-device Recognizer's")
        report["sharded_decode"][f"beam{beam}"] = entry
    if mesh.tp > 1:
        f32 = cfg.replace(model=cfg.model.replace(dtype="float32"))
        rec = Recognizer(f32, whole, mesh=mesh)
        single_rec = Recognizer(f32, whole, device=dev) if mesh.is_main else None
        for beam in (DECODE["beam_size"], 1):
            decode = dict(DECODE, beam_size=beam)
            hyps = rec.decode_batch(audio, lens, **decode)
            if single_rec is not None:
                same = single_rec.decode_batch(audio, lens, **decode) == hyps
                report["sharded_decode"][f"beam{beam}"]["float32_tokens_equal"] = same
                if not same:
                    raise AssertionError(f"float32 sharded decode beam {beam}: tokens "
                                         "differ from the single-device Recognizer's")
    del rec, single_rec, whole
    torch.cuda.empty_cache()


def _parallel_trainer(torch, dev, root, counts, report):
    from speech_tranformer_pytorch_tpu_torch.config import get_config
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.parallel.mesh import make_mesh
    from speech_tranformer_pytorch_tpu_torch.recognize import load_recognizer

    import torch.distributed as dist

    cfg = get_config("base", **{"train.batch_size": 8, "train.num_epochs": 100,
                                "train.log_every": 1, "train.checkpoint_every_steps": 100,
                                "train.eval_every_steps": 2, "mesh.model_axis": 1})
    mesh = make_mesh(cfg.mesh, device=dev)
    if mesh.is_main:
        os.makedirs(f"{root}/corpus")
        _write_corpus(f"{root}/corpus", cfg.model.vocab_size)
    dist.barrier()
    paths = {s: f"{root}/corpus/{s}.jsonl" for s in ("train", "test")}
    steps = PARALLEL_TRAINER_STEPS
    total = {k: 0 for k in interface.launch_counts()}
    interface.reset_launch_counts()
    straight, sps = _trainer_run(torch, dev, cfg, f"{root}/a", paths, steps, total,
                                 mesh=mesh, dev_manifest=paths["test"])
    _trainer_run(torch, dev, cfg, f"{root}/b", paths, steps // 2, total, mesh=mesh)
    _trainer_run(torch, dev, cfg, f"{root}/b", paths, steps, total, mesh=mesh, resume=True)
    rec = load_recognizer(cfg, f"{root}/a/checkpoints", mesh=mesh)
    before = interface.launch_counts()
    scores = rec.decode_manifest(paths["test"], beam_size=5, max_len=100, batch_size=8,
                                 distributed=True)
    _add(total, _launch_delta(before, interface.launch_counts()))
    _add(counts, total)
    report["trainer"] = {"mesh": mesh.shape, "steps_per_s": sps, "scores": scores,
                         "dev_decode_steps": straight.dev_decode_steps,
                         "best_dev_step": straight.best_dev_step, "launches": total}
    if mesh.is_main:
        a, b_ = (torch.load(f"{root}/{w}/checkpoints/step_{steps}.pt", weights_only=True)
                 for w in ("a", "b"))
        same = all(torch.equal(v, b_[part][k]) for part in ("params", "mu", "nu")
                   for k, v in a[part].items())
        report["trainer"]["resume_bit_identical"] = same
        if not same:
            raise AssertionError("a resumed mesh Trainer differs from the straight run")


def _parallel_rank(rank, root):
    """One rank of ``parallel_path``: its report and its launches."""
    import torch

    dev = torch.device("cuda", rank)
    counts, report = {}, {"rank": rank}
    _parallel_sharded(torch, dev, counts, report)
    _parallel_trainer(torch, dev, f"{root}/trainer", counts, report)
    return {"report": report, "counts": counts}


def parallel_path(torch, dev):
    import tempfile

    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.parallel.mesh import spawn_ranks

    n = torch.cuda.device_count()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()            # this process's cached blocks, for the ranks
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(_parallel_rank, n, tmp, device="cuda")
    scores = [r["report"]["trainer"]["scores"] for r in ranks]
    plain = lambda s: {k: v for k, v in s.items() if not k.startswith("rtf")}
    if any(plain(s) != plain(scores[0]) for s in scores):
        raise AssertionError(f"decode_manifest(distributed=True) scores differ: {scores}")
    counts = {k: ranks[0]["counts"].get(k, 0) for k in interface.launch_counts()}
    emit({"parallel_path": {"world": n, "ranks": [r["report"] for r in ranks],
                            "launches_rank0": counts}})
    return counts


CHECKS = ("check_fbank", "check_beam_prune", "check_lineage", "check_cross_attention",
          "check_relpos_attention",
          "check_flash", "check_ring_blocks", "check_adam", "check_int8_matmul",
          "check_int8_ffn")
PHASES = CHECKS + ("graph_decode", "ctc_decode", "conformer_decode", "whisper_decode",
                   "main_path", "export_path", "card_vs_cpu", "int8_path",
                   "int8_card_vs_cpu", "train_path", "large_train_path",
                   "train_card_vs_cpu", "overfit_anchor", "manifest_path", "pipeline_path",
                   "drive_recipe", "parallel_path")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ", ".join(PHASES))
    phases = ap.parse_args().phases.split(",")
    bad = [p for p in phases if p not in PHASES]
    if bad:
        print(f"chip_smoke: unknown phases {bad}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from speech_tranformer_pytorch_tpu_torch.device import resolve_device
    from speech_tranformer_pytorch_tpu_torch.kernels import _build

    dev = resolve_device("cuda")
    card = smi_line()
    print(card, flush=True)
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    _build.build(verbose=True)
    emit({"build_s": time.perf_counter() - t0})

    recs, ring = [], {}
    for name in CHECKS:
        if name in phases:
            t0 = time.perf_counter()
            out = globals()[name](torch, dev)
            if name == "check_ring_blocks":   # the flash kernels' ring route
                ring = out
            else:
                recs += out if isinstance(out, list) else [out]
            emit({"phase_s": {name: time.perf_counter() - t0}})
    if "graph_decode" in phases:
        t0 = time.perf_counter()
        graph_decode(torch, dev)
        emit({"phase_s": {"graph_decode": time.perf_counter() - t0}})
    counts = {"serve": {}, "export": {}, "serve_int8": {}, "ctc": {}, "conformer": {},
              "whisper": {}, "train": {}, "large": {},
              "large_master": {},
              "large_trainer": {}, "librispeech": {}, "manifest": {}, "pipeline": {},
              "recipe": {}, "parallel": {}}
    if "ctc_decode" in phases:
        t0 = time.perf_counter()
        rec, counts["ctc"] = ctc_decode(torch, dev)
        recs.append(rec)
        emit({"phase_s": {"ctc_decode": time.perf_counter() - t0}})
    if "conformer_decode" in phases:
        t0 = time.perf_counter()
        rec, counts["conformer"] = conformer_decode(torch, dev,
                                                    "check_relpos_attention" not in phases)
        if rec is not None:
            recs.append(rec)
        emit({"phase_s": {"conformer_decode": time.perf_counter() - t0}})
    if "whisper_decode" in phases:
        t0 = time.perf_counter()
        counts["whisper"] = whisper_decode(torch, dev)
        emit({"phase_s": {"whisper_decode": time.perf_counter() - t0}})
    for path, int8 in (("serve", False), ("serve_int8", True)):
        name = "int8_path" if int8 else "main_path"
        if name in phases:
            t0 = time.perf_counter()
            counts[path], params, audio, lens = main_path(torch, dev, int8=int8)
            if ("int8_" if int8 else "") + "card_vs_cpu" in phases:
                card_vs_cpu(torch, dev, params, audio, lens, int8=int8)
            emit({"phase_s": {name: time.perf_counter() - t0}})
        if path == "serve" and "export_path" in phases:
            t0 = time.perf_counter()
            counts["export"] = export_path(torch, dev)
            emit({"phase_s": {"export_path": time.perf_counter() - t0}})
    if "train_path" in phases:
        counts["train"] = train_path(torch, dev)
    if "large_train_path" in phases:
        t0 = time.perf_counter()
        counts.update(large_train_path(torch, dev))
        emit({"phase_s": {"large_train_path": time.perf_counter() - t0}})
    for name in ("train_card_vs_cpu", "overfit_anchor"):
        if name in phases:
            t0 = time.perf_counter()
            globals()[name](torch, dev)
            emit({"phase_s": {name: time.perf_counter() - t0}})
    for path, name in (("manifest", "manifest_path"), ("pipeline", "pipeline_path"),
                       ("recipe", "drive_recipe"), ("parallel", "parallel_path")):
        if name in phases:
            t0 = time.perf_counter()
            counts[path] = globals()[name](torch, dev)
            emit({"phase_s": {name: time.perf_counter() - t0}})

    kernels = []
    for r in recs:
        by_path = {path: c.get(r["name"], 0) for path, c in counts.items()}
        kernels.append({"name": r["name"], "route": "cuda", "source": r["source"],
                        "replaces": r["replaces"], "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if r["name"] in ring:
            kernels[-1]["ring_route"] = ring[r["name"]]
    if len(phases) == len(PHASES) and any(k["launches"] == 0 for k in kernels):
        raise AssertionError(f"a kernel never ran on a main path: {kernels}")
    leaked = stop_started_processes()
    if leaked:
        raise AssertionError(f"processes left running (now stopped): {leaked}")
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:   # also when a phase failed
        stop_started_processes()
    sys.exit(rc)
