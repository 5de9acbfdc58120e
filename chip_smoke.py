#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py [--phases name,name,...]

Phases (any failure exits non-zero before the final line):
  1. the card's name and power limit, as nvidia-smi prints them;
  2. build the CUDA kernels from ``speech_tranformer_pytorch_tpu_torch/csrc``
     and check each against its plain PyTorch version on the card, at the
     main paths' shapes, with timings (CUDA events) and the roofline bound:
     fbank (``check_fbank``: the FFT kernel at the serving and train
     batches, hann without pre-emphasis or log, hamming, an all-zero
     utterance, a partial last tile, and the DFT kernel at fft_length 400;
     every case bit-identical on a second call; timed at both batches),
     beam prune (``check_beam_prune``: the JAX goldens' tie, dead-row and
     saturation cases, K 8 with k2 16, K 10 with k2 20 on the two-launch
     kernel, V 5000, V 4337 and 32 utterances; indices exact, every case
     bit-identical on a second call; one device kernel a call on the main
     shape), lineage attention (beam 5, a shared history,
     L 256 and K = 1), flash attention forward, dK/dV and dQ
     (``check_flash``: the train shapes,
     zero-length rows, D 20, T' 750 and D 128, causal and not, and the
     bf16 forward and backward bit-identical on a second call), the fused
     Adam (``check_adam``), the int8 matmul (``check_int8_matmul``: every
     shape bit-identical on a second call, timed at the decode and
     ``init_cache`` shapes) and the fused int8 feed-forward
     (``check_int8_ffn``: every shape bit-identical on a second call,
     timed at the beam-5 and greedy decode shapes); lineage attention is
     bit-identical on a second call in every case and timed at three
     decode indices and at K = 1;
  3. the serving main path: ``Recognizer.decode_batch`` at the ``base``
     preset (full width, bf16, seeded random weights) serving 8 int16
     utterances of 4-6 s with beam 5 and max_len 100, with the kernels'
     exact launch counts; then the int8 serving path (``int8_path``): the
     same batch with int8 weights and the int8 cross-K/V cache, at beam 5
     and greedily (beam 1), each with exact launch counts;
  4. each serving path in float32 on 2 utterances, on the card with the
     kernels and on the CPU with the plain versions (``card_vs_cpu``,
     ``int8_card_vs_cpu`` at beam 5 and at beam 1, greedy): hypotheses
     must be identical and the first step's logits within 1e-3;
  5. the train main path (``train_path``): 3 + 10 steps of the ``base``
     preset (full width and depth, bf16 over f32 masters, dropout 0.1) on
     64 int16 utterances, with exact per-step launch counts;
  6. one float32 train step on 2 utterances, card against CPU
     (``train_card_vs_cpu``), and the overfit anchor: 300 steps of a small
     model on 10 synthetic utterances, then exact beam decoding;
  7. one JSON line per kernel set, then ``{"ok": true, "device": ...}``.
``--phases`` runs a subset (the kernel checks need no main path); with no
arguments every phase runs. Imports nothing of JAX or of the JAX package.
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
H100_BF16_FLOP_PER_S = 989e12   # dense bf16 tensor cores, same sheet
PKG = "speech_tranformer_pytorch_tpu_torch"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    zero = serve.clone()
    zero[3] = 0.0
    g = torch.Generator().manual_seed(8)
    ragged = (torch.randn(3, 6167, generator=g) * 0.1).to(dev)
    cases = [("serve", serve, fcfg), ("train", train, fcfg),
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
    for name, wave in (("serve", serve), ("train", train)):
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
               shape=main["shape"], train=timed["train"])
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


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
# second call. Timed in bf16 at index 0, 49 and 99 of the beam-5 cache and
# at K = 1 on 8 rows; the kernels line reports index 49.
LINEAGE_TIMED = (("beam5", 5, 100, 0), ("beam5", 5, 100, 49), ("beam5", 5, 100, 99),
                 ("greedy", 1, 100, 49))


def check_lineage(torch, dev):
    from torch.nn import functional as F
    from speech_tranformer_pytorch_tpu_torch.kernels import lineage_attention as la

    b, h, d = 8, 8, 64
    g = torch.Generator().manual_seed(2)

    def inputs(index, dtype, k=5, L=100, shared=False):
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
    errs, failed = {}, []
    for dtype, atol in ((torch.float32, 2e-6), (torch.bfloat16, 2e-2)):
        for label, kw in cases:
            k = kw.get("k", 5)
            args = inputs(dtype=dtype, **kw)
            got = la.lineage_attention_cuda(*args, kw["index"], k)
            again = la.lineage_attention_cuda(*args, kw["index"], k)
            want = la.lineage_attention_reference(*args, kw["index"], k)
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
    for label, k, L, index in LINEAGE_TIMED:
        args = inputs(index, torch.bfloat16, k=k, L=L)
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
        rec = dict(ms=device_ms(torch, lambda: la.lineage_attention_cuda(*args, index, k)),
                   plain_ms=device_ms(torch, lambda: la.lineage_attention_reference(
                       *args, index, k)),
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
               shape=[b * 5, 100, h, d, 49])
    emit({"check": rec})
    return rec


# Flash attention: the train path's three shapes (B 64, H 8, D 64; encoder
# T' 99-149, targets 11-31 of U 32), a zero-length row and ragged tiles,
# D 20 (off the 16-byte grid: the bf16 backward reads a padded copy),
# the `large` preset's 3000-frame buckets after 4x subsampling (T' 750,
# many tiles a block) and the `sharded` preset's head (D 128), causal and
# not. Tolerances: f32 as the JAX goldens (tests/test_flash_attention.py:
# 2e-3 forward, 5e-3 gradients); bf16 2e-2 of each tensor's largest value
# plus 2e-2 relative, because the bf16 kernels round p (forward and
# backward) and dS to bf16 before their tensor-core products, at other
# points of the online softmax than the plain version, and round every
# output to bf16 (a relative step of 2^-8).
FLASH_TOL = {"float32": ((2e-3, 2e-3), (5e-3, 5e-3)),
             "bfloat16": ((2e-2, 2e-2), (2e-2, 2e-2))}
TRAIN_SHAPES = ("encoder_self", "decoder_self", "cross")


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
            ("wide_head_causal", 8, 149, 149, wide, True, True, 16, 128)]


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
            timed = dtype == torch.bfloat16 and name in TRAIN_SHAPES
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
            rec = {
                "flash_fwd": dict(
                    ms=device_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, lens, causal=causal)),
                    plain_ms=device_ms(torch, lambda: fa.flash_fwd_reference(
                        q, k, v, lens, causal=causal)),
                    library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=keep)),
                    nbytes=2 * io_q + 2 * io_k + stat, flops=4 * d * pairs),
                "flash_bwd_dkv": dict(
                    ms=device_ms(torch, lambda: fa.flash_bwd_dkv_cuda(
                        q, k, v, do, lse_r, di, lens, causal=causal)),
                    plain_ms=device_ms(torch, lambda: fa.flash_bwd_dkv_reference(
                        q, k, v, do, lse_r, di, lens, causal=causal)),
                    nbytes=2 * io_q + 4 * io_k + 2 * stat, flops=8 * d * pairs),
                "flash_bwd_dq": dict(
                    ms=device_ms(torch, lambda: fa.flash_bwd_dq_cuda(
                        q, k, v, do, lse_r, di, lens, causal=causal)),
                    plain_ms=device_ms(torch, lambda: fa.flash_bwd_dq_reference(
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
    # The kernels line reports the encoder self-attention shape; each train
    # step runs every shape 6 times.
    recs = []
    for kname, line in (("flash_fwd", 85), ("flash_bwd_dkv", 248), ("flash_bwd_dq", 313)):
        main = per_shape["encoder_self"][kname]
        rec = dict(name=kname, source=f"{PKG}/csrc/flash_attention.cu",
                   replaces=f"speech_tranformer_pytorch_tpu/kernels/flash_attention.py:{line}",
                   max_abs_err=max(per_shape[s][kname]["max_abs_err"] for s in per_shape),
                   ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                   bound_by=main["bound_by"], library_ms=main["library_ms"],
                   shape=[64, 8, 149, 149, 64],
                   per_train_step_ms={k: 6 * sum(per_shape[s][kname][k] for s in per_shape)
                                      for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
        emit({"check": rec})
        recs.append(rec)
    return recs


def _bf16_ulp(torch, x):
    """The spacing of bfloat16 values at |x| (the smallest normal's at 0)."""
    x = x.float().abs().clamp(min=torch.finfo(torch.bfloat16).tiny)
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


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
            p_k, p_r = [x.clone() for x in params], [x.clone() for x in params]
            mu_k, nu_k = [x.to(mdt) for x in mu0], [x.to(mdt) for x in nu0]
            mu_r, nu_r = [x.clone() for x in mu_k], [x.clone() for x in nu_k]
            fa.fused_adam_cuda(p_k, gs, mu_k, nu_k, sc, **hyper)
            fa.adam_update_reference(p_r, gs, mu_r, nu_r, sc, **hyper)
            torch.cuda.synchronize()
            tag = f"fused_adam[{str(mdt)[6:]},clip={'on' if clip_active else 'off'}]"
            cat = lambda xs: torch.cat([x.reshape(-1).float() for x in xs])
            rec = {}
            for what, got, want in (("p", p_k, p_r), ("mu", mu_k, mu_r), ("nu", nu_k, nu_r)):
                a, b = cat(got), cat(want)
                diff = (a - b).abs()
                if mdt == torch.bfloat16 and what != "p":
                    bad = diff > _bf16_ulp(torch, b)      # within one bf16 ulp
                else:
                    bad = diff > 1e-6 * b.abs()           # within 1e-6 relative
                if bool(bad.any()):
                    raise AssertionError(f"{tag}.{what}: {int(bad.sum())} elements off; "
                                         f"max abs err {float(diff.max())}")
                rec[what] = {"max_abs_err": float(diff.max()),
                             "bit_exact": bool(torch.equal(a, b))}
            errs[tag] = rec
            emit({"check": {"name": tag, **rec}})
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
    rec = dict(name="fused_adam", source=f"{PKG}/csrc/fused_adam.cu",
               replaces="speech_tranformer_pytorch_tpu/ops/fused_adam.py:46",
               max_abs_err=max(r[w]["max_abs_err"] for r in errs.values() for w in r),
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms,
               library_note="torch.optim.Adam(fused=True) on the same f32 tree; "
                            "it keeps f32 moments (28 B a parameter, not 20)",
               params=n, leaves=len(shapes))
    emit({"check": rec})
    return rec


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
# K/V projections of init_cache (B·S = 1192 rows), a wide layer, a single
# row and a ragged one. Tolerances: f32 within 1e-5 of each row's largest
# value (summation order only); bf16 within one bf16 ulp of the plain
# version's value (the same f32 value, rounded once to bf16) plus the same
# 1e-5 of the row's largest value (outputs near 0 come from cancelling
# sums, whose order-dependent f32 error exceeds their own ulp). Two calls
# on the same inputs must be bit-equal (the split-k partials are summed in
# a fixed order). The first four bf16 shapes and init_cache's are timed;
# the kernels line reports the first.
INT8_MATMUL_SHAPES = [(40, 512, 1536), (40, 512, 512), (8, 512, 1536), (8, 512, 512),
                      (1192, 512, 512), (48, 2048, 6144), (1, 512, 512), (7, 96, 200)]
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


# Fused int8 feed-forward: the base decode shapes (B·K = 40, greedy 8), the
# `large` preset's (d_model 768, d_ff 3072), more than 64 rows (three row
# tiles) and a ragged one. Tolerances: f32 within 1e-5 of each row's
# largest value; bf16 within 1e-3 of it (the JAX kernel's bound: the hidden
# layer is rounded to bf16 after differently ordered sums) plus one bf16
# ulp of the output. Two calls on the same inputs must be bit-equal. The
# two base decode shapes are timed; the kernels line reports the first.
INT8_FFN_SHAPES = [(40, 512, 2048, 512), (8, 512, 2048, 512), (40, 768, 3072, 768),
                   (130, 512, 2048, 512), (7, 96, 200, 72)]
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


TRAIN_STEP_LAUNCHES = {"stft_mel": 1, "beam_prune": 0, "lineage_attention": 0,
                       "flash_fwd": 18, "flash_bwd_dkv": 18, "flash_bwd_dq": 18,
                       "fused_adam": 1, "int8_matmul": 0, "int8_ffn": 0}


def train_path(torch, dev):
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.profile_train import (
        TIMED_STEPS, WARMUP_STEPS, smoke_train_batch)

    smoke = smoke_train_batch(dev)
    state, batch, step, cfg = smoke.state, smoke.batch, smoke.step, smoke.cfg
    layers = cfg.model.num_encoder_layers + 2 * cfg.model.num_decoder_layers
    if TRAIN_STEP_LAUNCHES["flash_fwd"] != layers:
        raise AssertionError(f"{layers} attention layers, not 18")
    before = {k: p.detach().clone() for k, p in state.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls, losses, norms = [], [], []
    interface.reset_launch_counts()
    prev = interface.launch_counts()
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        now = interface.launch_counts()
        per_step = {k: now[k] - prev[k] for k in now}
        if per_step != TRAIN_STEP_LAUNCHES:
            raise AssertionError(f"step {i}: launches {per_step}, expected "
                                 f"{TRAIN_STEP_LAUNCHES}")
        prev = now
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
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
        "launches_per_step": TRAIN_STEP_LAUNCHES, "launches": counts}})
    return counts


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


def expected_serve_launches(cfg, steps: int, int8: bool, beam: int):
    """Exact kernel launches of one served batch of ``steps`` decode steps
    (beam search, or greedy decoding at ``beam == 1``)."""
    m = cfg.model
    layer_step = (1 if m.fused_qkv else 3) + 3    # self q/k/v, self out, cross q, cross out
    want = {k: 0 for k in TRAIN_STEP_LAUNCHES}
    want.update({"stft_mel": 1, "beam_prune": steps if beam > 1 else 0,
                 "lineage_attention": m.num_decoder_layers * steps,
                 "flash_fwd": m.num_encoder_layers})
    if int8:   # + the cross K and V projections of init_cache
        want["int8_matmul"] = m.num_decoder_layers * (layer_step * steps + 2)
        want["int8_ffn"] = m.num_decoder_layers * steps
    return want


def main_path(torch, dev, int8: bool = False):
    from speech_tranformer_pytorch_tpu_torch.kernels import interface
    from speech_tranformer_pytorch_tpu_torch.profile_decode import DECODE, smoke_batch

    # The batch profile_decode.py traces: base preset, seeded random
    # weights, 8 int16 utterances of 4-6 s, beam 5, max_len 100; with
    # ``int8`` the int8 weights and int8 cross-K/V cache.
    cfg, params, rec, audio, lens = smoke_batch(dev, int8=int8)
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
    want = expected_serve_launches(cfg, steps, int8, DECODE["beam_size"])
    if steps <= 0 or counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
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
        "launches": counts, "hyp_lens": [len(h) for h in hyps]}})
    return counts, params, audio, lens


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
                logits, _ = rec.model.decode_step(sos, 0, cache, mem_lens, beam, lineage)
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


CHECKS = ("check_fbank", "check_beam_prune", "check_lineage", "check_flash",
          "check_adam", "check_int8_matmul", "check_int8_ffn")
PHASES = CHECKS + ("main_path", "card_vs_cpu", "int8_path", "int8_card_vs_cpu",
                   "train_path", "train_card_vs_cpu", "overfit_anchor")


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

    recs = []
    for name in CHECKS:
        if name in phases:
            t0 = time.perf_counter()
            out = globals()[name](torch, dev)
            recs += out if isinstance(out, list) else [out]
            emit({"phase_s": {name: time.perf_counter() - t0}})
    counts = {"serve": {}, "serve_int8": {}, "train": {}}
    for path, int8 in (("serve", False), ("serve_int8", True)):
        name = "int8_path" if int8 else "main_path"
        if name in phases:
            t0 = time.perf_counter()
            counts[path], params, audio, lens = main_path(torch, dev, int8=int8)
            if ("int8_" if int8 else "") + "card_vs_cpu" in phases:
                card_vs_cpu(torch, dev, params, audio, lens, int8=int8)
            emit({"phase_s": {name: time.perf_counter() - t0}})
    if "train_path" in phases:
        counts["train"] = train_path(torch, dev)
    for name in ("train_card_vs_cpu", "overfit_anchor"):
        if name in phases:
            t0 = time.perf_counter()
            globals()[name](torch, dev)
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
    if len(phases) == len(PHASES) and any(k["launches"] == 0 for k in kernels):
        raise AssertionError(f"a kernel never ran on a main path: {kernels}")
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
