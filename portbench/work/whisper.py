"""Model FLOPs and minimal bytes of a served Whisper call
(``features.kind`` 'whisper', ``drivers/serve_whisper.py``), in two kinds
of parts: the call's prologue (the Conv1d stem, the encoder over every
frame of the window, the cross-attention cache and the forced prompt's
tokens) and each decode step at its cache position.

FLOPs count 2 m n k for every product of the forward pass, as
``work/model.py`` counts the Speech-Transformer: the stem's two
convolutions, per encoder layer the q/k/v and output projections, QKᵀ and
PV over all t frames (4 t² d) and the feed-forward, the cross K/V
projections of every decoder layer, the prompt's n tokens before its
last through every decoder layer once an utterance (no logits: the work
the prompt needs, which the port does at every lane), and a step's rows
through ``work/model.decode_row_flops`` at their cache position (the tied
logits included).

Minimal bytes, in bf16 unless stated: the prologue reads the int16 PCM of
the window, every encoder weight, the decoder's cross K/V weights and, for
the prompt, every other decoder layer weight once, and writes the cross
cache; a step reads the decoder layers' weights but the cross K/V
projections once, every utterance's cross cache once, the self K/V rows
of the lineage floor (``work/lineage.distinct_rows``, each utterance's
prompt rows besides) and the tied table, and writes the f32
logits of its rows. A part's bound is the larger of its FLOPs over the
bf16 peak and its bytes over the HBM bandwidth.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..peaks import BF16_FLOP_PER_S, bound_s
from ..reference.whisper import N_FRAMES
from .lineage import distinct_rows
from .model import decode_row_flops

ESZ = 2     # bf16


def prompt_offset(cfg: dict) -> int:
    """Cache positions the prompt fills before the first step: all its
    tokens but the last."""
    return max(len(cfg["decode"]["prompt"]) - 1, 0)


def _layer_params(m: dict):
    """(encoder layer, decoder layer less its cross K/V, cross K/V) weights."""
    d, ff = m["d_model"], m["d_ff"]
    return 4 * d * d + 2 * d * ff, 6 * d * d + 2 * d * ff, 2 * d * d


def prologue_counts(cfg: dict, batch: int, t: int):
    """(FLOPs, bytes) of a call's prologue over ``batch`` windows of ``t``
    encoder frames."""
    m = cfg["model"]
    d, ff, mels = m["d_model"], m["d_ff"], m["input_dim"]
    enc_l, dec_l, cross_l = _layer_params(m)
    f = cfg["features"]
    frames_in = N_FRAMES
    hop = int(f["sample_rate"] * f["frame_shift_ms"] / 1000.0)
    n = prompt_offset(cfg)
    enc = (2.0 * frames_in * mels * 3 * d + 2.0 * t * d * 3 * d
           + m["num_encoder_layers"] * (2.0 * t * d * 3 * d + 4.0 * t * t * d
                                        + 2.0 * t * d * d + 4.0 * t * d * ff))
    cross = m["num_decoder_layers"] * 2.0 * t * d * 2 * d
    prompt = m["num_decoder_layers"] * sum(
        2.0 * d * 3 * d + 4.0 * d * (j + 1) + 6.0 * d * d + 4.0 * d * t + 4.0 * d * ff
        for j in range(n))
    flops = batch * (enc + cross + prompt)
    weights = (mels * 3 * d + 3 * d * d + m["num_encoder_layers"] * enc_l
               + m["num_decoder_layers"] * (cross_l + (dec_l if n else 0)))
    pcm = batch * frames_in * hop * 2
    cache = batch * m["num_decoder_layers"] * 2 * t * d * ESZ
    return flops, float(weights * ESZ + pcm + cache)


def step_counts(cfg: dict, batch: int, beam: int, t: int, position: int, rows_read: int):
    """(FLOPs, bytes) of one decode step of ``batch`` x ``beam`` rows at
    cache position ``position``, reading ``rows_read`` distinct self K/V
    rows of each layer."""
    m = cfg["model"]
    d, v = m["d_model"], m["vocab_size"]
    _, dec_l, _ = _layer_params(m)
    rows = batch * beam
    layers = m["num_decoder_layers"]
    flops = rows * decode_row_flops(m, position, t)
    nbytes = (layers * dec_l * ESZ + layers * batch * 2 * t * d * ESZ
              + layers * rows_read * 2 * d * ESZ + v * d * ESZ + rows * v * 4)
    return flops, float(nbytes)


def call_parts(cfg: dict, item: dict) -> List[tuple]:
    """(FLOPs, bytes) of every part of a served call: its prologue, then
    each step run (``item``: ``b``, ``beam``, ``steps``, ``enc_frames`` and
    the served ``tokens`` [B, K, L] for the lineage floor)."""
    b, k, t = item["b"], item["beam"], item["enc_frames"]
    n = prompt_offset(cfg)
    parts = [prologue_counts(cfg, b, t)]
    floor = distinct_rows(np.asarray(item["tokens"]), item["steps"])
    parts += [step_counts(cfg, b, k, t, n + i, floor[i] + b * n)
              for i in range(item["steps"])]
    return parts


def call_flops(cfg: dict, item: dict) -> float:
    return sum(f for f, _ in call_parts(cfg, item))


def call_bound_s(cfg: dict, item: dict) -> float:
    """The least time of a served call: each part's bound, summed."""
    return sum(bound_s(nbytes, flops, BF16_FLOP_PER_S) for flops, nbytes in call_parts(cfg, item))
