"""The decode cross-attention's operation and byte counts (``work/cross.py``)
by hand at the `librispeech` cell's 3000 bucket, and its reader
(``cross_attention_roofline.serve``) on synthetic traces: its own kernel
alone, and nothing to read on a port without it."""

import numpy as np
import pytest

from portbench import metrics
from portbench.harness import Record
from portbench.trace import Trace, union_ns
from portbench.work import cross, model

from .conftest import tiny_config

M = dict(num_heads=8, d_model=512, num_decoder_layers=6, dtype="bfloat16")


def test_one_call_bound_by_hand_at_the_3000_bucket():
    # 16 utterances of 3000 fbank frames: 749 encoder frames each; beam 5,
    # H 8, D 64, bf16. Bytes: K and V of every valid frame once, q in and
    # the output out, the lengths; operations 4 K H T D an utterance.
    valid = [model.subsampled(3000)] * 16
    assert valid[0] == 749
    nbytes = 16 * 2 * 749 * 8 * 64 * 2 + 2 * 80 * 8 * 64 * 2 + 16 * 4
    ops = 16 * 4 * 5 * 8 * 749 * 64
    assert (nbytes, ops) == (24_707_136, 122_716_160)
    assert cross.call_counts(valid, 5, 8, 64) == (nbytes, float(ops))
    assert cross.call_bound_s(valid, 5, 8, 64) == pytest.approx(nbytes / 3.35e12)  # bytes
    # A served call: every decoder layer at every step, from fbank frames.
    assert cross.serve_bound_s(M, [3000] * 16, 5, 100) == pytest.approx(600 * nbytes / 3.35e12)


def test_ragged_lengths_and_float32_count_their_own_bytes():
    assert cross.call_counts([749, 10], 5, 8, 64)[0] == (2 * 759 * 8 * 64 * 2
                                                         + 2 * 10 * 8 * 64 * 2 + 8)
    f32 = dict(M, dtype="float32")
    assert cross.serve_bound_s(f32, [3000], 1, 1) == pytest.approx(
        6 * cross.call_bound_s([749], 1, 8, 64, esz=4))


ITEMS = [dict(batch=0, wall_s=0.1, audio_s=3.0, steps=6, b=2, beam=3, frames=[120, 98],
              max_len=6, tokens=np.full((2, 3, 6), 5)),
         dict(batch=1, wall_s=0.2, audio_s=4.0, steps=4, b=2, beam=3, frames=[200, 150],
              max_len=4, tokens=np.full((2, 3, 4), 5))]
CTX = type("Ctx", (), {"cfg": {"model": tiny_config()["model"]}})()


def _record(kind, ops):
    busy, _ = union_ns((s, e) for _, s, e in ops)
    trace = Trace(window_s=1.0, busy_s=busy / 1e9, device_ops=ops, launches=10, top_ops=[],
                  idle_gaps=[])
    return Record(kind=kind, setup_s=1.0, window_s=1.0, items=ITEMS, peak_bytes=0,
                  attempted=2, failed=0, numbers={}, trace=trace)


def test_the_reader_reads_the_cross_attention_kernel_alone():
    read = metrics.reader("cross_attention_roofline.serve").read
    m = CTX.cfg["model"]
    bound = sum(cross.serve_bound_s(m, it["frames"], it["beam"], it["steps"]) for it in ITEMS)
    ops = [("void (anonymous namespace)::cross_attention_decode_kernel<__nv_bfloat16, 8, 64>"
            "(...)", 0, 3000), ("void gemmSN_NN_kernel<float, 128, 2, 4, 8, 5, 4>", 0, 10 ** 6)]
    assert read(_record("serve", ops), CTX) == pytest.approx(100 * bound / 3e-6)
    # The einsum route (a port without the kernel) and training read nothing.
    assert read(_record("serve", ops[1:]), CTX) is None
    assert read(_record("train", ops), CTX) is None
    untraced = _record("serve", ops)
    untraced.trace = None
    assert read(untraced, CTX) is None
