"""Each metric reader on a synthetic trace, and the trace reduction on a
real (host-only) profiler window."""

import numpy as np
import pytest
import torch

from portbench import metrics
from portbench.harness import Record
from portbench.trace import Trace, reduce, traced, union_ns
from portbench.work import flash, lineage, model

from .conftest import tiny_config, tiny_context

CFG = {"model": tiny_config()["model"]}
CTX = type("Ctx", (), {"cfg": CFG})()

SERVE_ITEMS = [dict(batch=0, wall_s=0.1, audio_s=3.0, steps=6, b=2, beam=3,
                    frames=[120, 98], max_len=6,
                    tokens=np.arange(4, 40).reshape(2, 3, 6) % 7 + 4),
               dict(batch=1, wall_s=0.2, audio_s=4.0, steps=4, b=2, beam=3,
                    frames=[200, 150], max_len=4, tokens=np.full((2, 3, 4), 5))]
TRAIN_ITEMS = [dict(batch=0, audio_s=5.0, b=2, frames_pad=200, frames=[200, 150],
                    u_pad=16, target_lens=[9, 7])]


def _trace(ops, launches=100, window=1.0):
    busy, _ = union_ns((s, e) for _, s, e in ops)
    return Trace(window_s=window, busy_s=busy / 1e9, device_ops=ops, launches=launches,
                 top_ops=[], idle_gaps=[])


def _record(kind, items, trace):
    return Record(kind=kind, setup_s=1.5, window_s=2.0, items=items, peak_bytes=3 * 2 ** 30,
                  attempted=len(items), failed=0, numbers={}, trace=trace)


def read(name, record):
    return metrics.reader(name).read(record, CTX)


def test_end_to_end_readers():
    r = _record("serve", SERVE_ITEMS * 10, None)
    assert read("setup_s", r) == 1.5
    assert read("peak_mem_gib", r) == 3.0
    assert read("serve_audio_s_per_s", r) == pytest.approx(70.0 / 2.0)
    assert read("serve_p95_s", r) == pytest.approx(0.2)
    assert read("train_audio_s_per_s", r) is None
    assert read("train_audio_s_per_s", _record("train", TRAIN_ITEMS, None)) == 2.5


def test_idle_share_is_the_window_outside_the_union_of_device_intervals():
    ops = [("k1", 0, 200_000_000), ("k2", 100_000_000, 300_000_000), ("k3", 500_000_000, 600_000_000)]
    r = _record("serve", SERVE_ITEMS, _trace(ops))
    assert read("serve.device_idle_share", r) == pytest.approx(60.0)
    assert read("train.device_idle_share", r) is None
    assert read("serve.device_idle_share", _record("serve", SERVE_ITEMS, None)) is None


def test_launch_ratios():
    r = _record("serve", SERVE_ITEMS, _trace([("k", 0, 10)], launches=2200))
    assert read("serve.launches_per_decode_step", r) == pytest.approx(220.0)
    t = _record("train", TRAIN_ITEMS * 4, _trace([("k", 0, 10)], launches=6800))
    assert read("train.launches_per_step", t) == pytest.approx(1700.0)


def test_mfu_counts_the_model_over_the_window():
    r = _record("train", TRAIN_ITEMS, _trace([("k", 0, 10)], window=0.5))
    want = model.train_step_flops(CFG["model"], [200, 150], [9, 7]) / (0.5 * 989e12)
    assert read("train.mfu", r) == pytest.approx(100 * want)
    s = _record("serve", SERVE_ITEMS, _trace([("k", 0, 10)], window=0.5))
    f = sum(model.serve_call_flops(CFG["model"], it["frames"], 3, it["steps"]) for it in SERVE_ITEMS)
    assert read("serve.mfu", s) == pytest.approx(100 * f / (0.5 * 989e12))
    # No device operation: nothing to read.
    assert read("serve.mfu", _record("serve", SERVE_ITEMS, _trace([]))) is None


def test_rooflines_read_their_own_kernels_only():
    m = CFG["model"]
    bound = flash.train_step_bound_s(m, 200, [200, 150], 16, [9, 7])
    ops = [("void flash_fwd_bf16_kernel(Params)", 0, 1000), ("flash_bwd_dkv_bf16_kernel", 0, 1000),
           ("flash_bwd_dq_bf16_kernel", 0, 2000), ("ampere_sgemm", 0, 10 ** 6)]
    r = _record("train", TRAIN_ITEMS, _trace(ops))
    assert read("flash_roofline.train", r) == pytest.approx(100 * bound / 4e-6)
    assert read("flash_roofline.train", _record("train", TRAIN_ITEMS, _trace(ops[3:]))) is None
    lb = sum(lineage.decode_call_bound_s(m, 2, 3, it["steps"], it["tokens"])
             for it in SERVE_ITEMS)
    ops = [("void lineage_attention_kernel<__nv_bfloat16>(...)", 0, 5000), ("gemm", 0, 10 ** 6)]
    s = _record("serve", SERVE_ITEMS, _trace(ops))
    assert read("lineage_roofline.serve", s) == pytest.approx(100 * lb / 5e-6)


def test_reduce_finds_the_window_and_names_the_gaps():
    with traced(True, torch.device("cpu")) as box:
        with torch.profiler.record_function("portbench.call"):
            x = torch.randn(64, 64)
            for _ in range(5):
                x = torch.tanh(x @ x)
    t = reduce(box[0])
    assert t.window_s > 0 and t.busy_s == 0 and t.launches == 0
    assert t.device_ops == [] and t.top_ops == []
    # With no device work the whole window is one gap, named by host events.
    assert sum(v for _, v in t.idle_gaps) == pytest.approx(t.window_s, rel=1e-6)


def test_a_traced_cpu_run_reports_no_device_metric():
    from portbench.drivers import serve

    r = serve.run(tiny_context("serve", trace=True))
    assert r.trace is not None and r.trace.busy_s == 0
    for name in ("serve.device_idle_share", "serve.mfu", "serve.launches_per_decode_step",
                 "lineage_roofline.serve"):
        assert metrics.reader(name).read(r, tiny_context("serve")) is None


def test_lineage_rows_are_the_distinct_prefixes_of_the_served_hypotheses():
    # Two utterances of three beams over 4 steps. Utterance 0: the beams
    # share their first token, then split; utterance 1: all three alike.
    tokens = np.array([[[7, 8, 9, 9], [7, 5, 9, 9], [7, 5, 6, 9]],
                       [[4, 4, 4, 4]] * 3])
    # step t: 6 own rows, plus at each position p < t the distinct prefixes
    # of length p (utterance 0: 1, 1, 2; utterance 1: 1, 1, 1).
    assert lineage.distinct_rows(tokens, 4) == [6, 6 + 2, 6 + 4, 6 + 7]
    # Never more than every lane of every position.
    assert all(n <= 6 * (t + 1) for t, n in enumerate(lineage.distinct_rows(tokens, 4)))

