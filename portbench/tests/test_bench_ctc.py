"""The hybrid CTC/attention serving cell (``drivers/serve_ctc.py``,
``reference/ctc.py``, ``calibrate_ctc.py`` and its two readers): on the CPU
at a tiny float32 size, a sound run reads rounding, and the control, an
altered token, the shifted prune and a CTC state that does not follow its
parent each make ``correct`` false; a configuration the port does not
know is refused before anything is built. On the chip (``-m chip``) the
control, the altered token and the CTC-state fault read above the cell's
committed limits."""

import types

import pytest
import torch

from portbench import calibrate, calibrate_ctc, manifest, metrics, run
from portbench.harness import Context, Record
from portbench.reference.model import Precision
from portbench.trace import Trace, union_ns
from portbench.work import ctc as work

from .conftest import tiny_config, tiny_mix

CELL = "librispeech.serve.ls-b16"
LIMITS = {"score_gap_mean": 1e-4, "prune_gap_mean": 1e-3}


def ctc_config() -> dict:
    cfg = tiny_config()
    cfg["model"]["ctc_head"] = True
    cfg["train"]["ctc_weight"] = 0.3
    cfg["decode"]["ctc_weight"] = 0.4
    return cfg


def ctc_mix() -> dict:
    return dict(tiny_mix("serve"), entry="serve_ctc", trace_items=4, check_calls=4)


def whole_run(seed=2 ** 31 + 5, trace=0):
    """``run.run_cell`` of the cell on the CPU at the tiny size."""
    bench = manifest.load()
    files = {"workload": manifest.workload(bench, CELL), "config": {"config": ctc_config()},
             "mix": ctc_mix(), "limits": LIMITS}
    args = types.SimpleNamespace(workload=CELL, seed=seed, seconds=0.3, trace=trace)
    return run.run_cell(bench, files, args, torch.device("cpu"), 0.0)


def numbers(out) -> dict:
    return {c["name"]: c["value"] for c in out["checks"]}


def test_a_sound_run_reads_rounding():
    out = whole_run(trace=1)
    got = numbers(out)
    assert out["correct"] is True, got
    assert got["score_gap_mean"] < 1e-5 and got["prune_gap_mean"] < 1e-4


def test_the_fp8_control_is_not_correct(monkeypatch):
    from portbench.drivers import serve_ctc

    real = serve_ctc.check
    monkeypatch.setattr(serve_ctc, "check", lambda ctx, pool, items, calls, control=None: real(
        ctx, pool, items, calls, Precision("fp8")))
    out = whole_run()
    assert out["correct"] is False
    assert numbers(out)["score_gap_mean"] > 10 * LIMITS["score_gap_mean"]


def test_an_altered_token_is_not_correct(monkeypatch):
    from portbench.drivers import serve_ctc

    real = serve_ctc.serve

    def altered(rec, hb, decode):
        out, steps = real(rec, hb, decode)
        return calibrate.alter_token(out, ctc_config()["model"]["vocab_size"]), steps

    monkeypatch.setattr(serve_ctc, "serve", altered)
    assert whole_run()["correct"] is False


def test_a_pre_beam_that_drops_the_best_token_is_not_correct():
    with calibrate.shifted_prune():
        out = whole_run(trace=1)
    assert out["correct"] is False
    assert numbers(out)["prune_gap_mean"] > 10 * LIMITS["prune_gap_mean"]


def test_a_ctc_state_that_does_not_follow_its_parent_is_not_correct():
    with calibrate_ctc.stale_ctc_state():
        out = whole_run(trace=1)
    assert out["correct"] is False
    assert numbers(out)["score_gap_mean"] > 10 * LIMITS["score_gap_mean"]


def test_a_configuration_the_port_does_not_know_is_refused():
    from portbench.drivers import serve_ctc

    serve_ctc.check_fields(ctc_config())
    cfg = ctc_config()
    cfg["decode"]["lm_weight"] = 0.6
    with pytest.raises(RuntimeError, match="decode.lm_weight"):
        serve_ctc.check_fields(cfg)


SERVE_ITEMS = [dict(batch=0, wall_s=0.1, audio_s=3.0, steps=6, b=2, beam=5,
                    frames=[2999, 2100], max_len=6),
               dict(batch=1, wall_s=0.2, audio_s=4.0, steps=4, b=2, beam=5,
                    frames=[200, 150], max_len=4)]


def test_the_readers_read_the_ctc_kernels_alone():
    ops = [("void (anonymous namespace)::ctc_prefix_kernel(float const*, ...)", 0, 4000),
           ("gemm", 2000, 10000)]
    busy, _ = union_ns((s, e) for _, s, e in ops)
    trace = Trace(window_s=1e-4, busy_s=busy / 1e9, device_ops=ops, launches=10, top_ops=[],
                  idle_gaps=[])
    rec = Record(kind="serve", setup_s=1.0, window_s=1.0, items=SERVE_ITEMS, peak_bytes=0,
                 attempted=2, failed=0, numbers={}, trace=trace)
    ctx = type("Ctx", (), {"cfg": {"model": ctc_config()["model"]}})()
    bound = sum(work.call_bound_s(it["frames"], 5, it["steps"]) for it in SERVE_ITEMS)
    roof = metrics.reader("ctc_prefix_roofline.serve").read(rec, ctx)
    assert roof == pytest.approx(100 * bound / 4e-6)
    assert metrics.reader("serve.ctc_device_share").read(rec, ctx) == pytest.approx(40.0)
    # 749 frames at step 0: every frame but the first, 7 candidates of 5 rows.
    nbytes, ops_ = work.step_counts([749], 5, 0)
    assert ops_ == 21 * 35 * 748 and nbytes == 4 * 748 * (105 + 10 + 1)
    rec.trace = Trace(window_s=1e-4, busy_s=8e-6, device_ops=ops[1:], launches=1, top_ops=[],
                      idle_gaps=[])
    for name in ("ctc_prefix_roofline.serve", "serve.ctc_device_share"):
        assert metrics.reader(name).read(rec, ctx) is None


@pytest.mark.chip
def test_control_and_faults_fail_at_the_cells_size(cuda):
    """The control, the altered token and the CTC state that does not
    follow its parent. The shifted prune is a reading only: at this size
    it fails ``prune_gap_mean`` on some seeds and not on others (the
    pre-beam's best token by attention is often not among the best by
    the combined score)."""
    files = manifest.context_files(manifest.load(), CELL)
    for what in ("control", "fault", "ctc"):
        ctx = Context(cell=CELL, config=files["config"], mix=files["mix"],
                      limits=files["limits"], seed=4242, seconds=0.0, trace=False,
                      device=cuda, t_start=0.0)
        nums = calibrate_ctc.reading(ctx, what)
        assert any(v > files["limits"][k] for k, v in nums.items()), (what, nums)
