"""The Conformer serving cell (``drivers/serve_conformer.py``,
``reference/conformer.py``, ``calibrate_conformer.py`` and its two
readers): on the CPU at a tiny float32 size, a sound run reads rounding,
and the control, a relative offset off by one in the port's attention and
a CTC state that does not follow its parent each make ``correct`` false; a
port without the Conformer's fields is refused before anything is built.
On the chip (``-m chip``) the control and the CTC-state fault read above
the cell's committed limits."""

import types

import pytest
import torch

from portbench import calibrate_conformer, calibrate_ctc, manifest, metrics, run
from portbench.harness import Context, Record
from portbench.reference.model import Precision
from portbench.trace import Trace, union_ns
from portbench.work import conformer as work
from portbench.work.model import subsampled

from .conftest import tiny_config, tiny_mix

CELL = "conformer.serve.ls-long-b32"
LIMITS = {"score_gap_mean": 1e-4, "prune_gap_mean": 1e-3}


def conformer_config() -> dict:
    cfg = tiny_config()
    cfg["model"].update(encoder="conformer", conv_kernel=7, ctc_head=True, d_model=32,
                        d_ff=64)
    cfg["train"]["ctc_weight"] = 0.3
    cfg["decode"]["ctc_weight"] = 0.3
    return cfg


def conformer_mix() -> dict:
    return dict(tiny_mix("serve"), entry="serve_conformer", trace_items=4, check_calls=4)


def whole_run(seed=2 ** 31 + 9, trace=0):
    """``run.run_cell`` of the cell on the CPU at the tiny size."""
    bench = manifest.load()
    files = {"workload": manifest.workload(bench, CELL),
             "config": {"config": conformer_config()}, "mix": conformer_mix(),
             "limits": LIMITS}
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
    from portbench.drivers import serve_conformer

    real = serve_conformer.check
    monkeypatch.setattr(serve_conformer, "check",
                        lambda ctx, pool, items, calls, control=None: real(
                            ctx, pool, items, calls, Precision("fp8")))
    out = whole_run()
    assert out["correct"] is False
    assert numbers(out)["score_gap_mean"] > 10 * LIMITS["score_gap_mean"]


def test_a_relative_offset_off_by_one_is_not_correct():
    with calibrate_conformer.shifted_positions():
        out = whole_run()
    assert out["correct"] is False
    assert numbers(out)["score_gap_mean"] > 10 * LIMITS["score_gap_mean"]


def test_a_ctc_state_that_does_not_follow_its_parent_is_not_correct():
    with calibrate_ctc.stale_ctc_state():
        out = whole_run()
    assert out["correct"] is False


def test_a_port_without_the_conformer_fields_is_refused(monkeypatch):
    import dataclasses

    from portbench.drivers import serve_conformer
    from speech_tranformer_pytorch_tpu_torch import config

    ctx = types.SimpleNamespace(cfg=conformer_config())
    serve_conformer.check_fields(ctx.cfg)
    whole = config.ExperimentConfig()
    fields = [f for f in dataclasses.fields(config.ModelConfig)
              if f.name not in ("encoder", "conv_kernel")]
    older = dataclasses.make_dataclass("ModelConfig", [(f.name, f.type, f) for f in fields])
    parent = types.SimpleNamespace(**{f.name: getattr(whole, f.name)
                                      for f in dataclasses.fields(whole)})
    parent.model = older()
    monkeypatch.setattr(config, "ExperimentConfig", lambda: parent)
    with pytest.raises(RuntimeError, match="model.encoder"):
        serve_conformer.run(ctx)


SERVE_ITEMS = [dict(batch=0, wall_s=0.1, audio_s=30.0, steps=6, b=2, beam=5,
                    frames=[2999, 2100], max_len=6),
               dict(batch=1, wall_s=0.2, audio_s=4.0, steps=4, b=2, beam=5,
                    frames=[200, 150], max_len=4)]


def test_the_readers_read_the_relpos_kernel_and_the_conformer_flops():
    ops = [("void (anonymous namespace)::relpos_attention_kernel<64>(Params)", 0, 4000),
           ("gemm", 2000, 10000)]
    busy, _ = union_ns((s, e) for _, s, e in ops)
    trace = Trace(window_s=1e-4, busy_s=busy / 1e9, device_ops=ops, launches=10, top_ops=[],
                  idle_gaps=[])
    rec = Record(kind="serve", setup_s=1.0, window_s=1.0, items=SERVE_ITEMS, peak_bytes=0,
                 attempted=2, failed=0, numbers={}, trace=trace)
    m = dict(conformer_config()["model"], d_model=512, num_heads=8, num_encoder_layers=12)
    ctx = type("Ctx", (), {"cfg": {"model": m}})()
    bound = sum(work.serve_relpos_bound_s(m, it["frames"]) for it in SERVE_ITEMS)
    roof = metrics.reader("relpos_attention_roofline.serve").read(rec, ctx)
    assert roof == pytest.approx(100 * bound / 4e-6)
    # One utterance of 749 valid frames at H 8, D 64: 6 H t^2 D operations,
    # q, k, v, the output and 2t - 1 position rows of bf16.
    nbytes, ops_ = work.relpos_counts([749], 8, 64)
    assert ops_ == 6 * 8 * 749 * 749 * 64 and nbytes == (4 * 749 + 1497) * 8 * 64 * 2
    flops = sum(work.serve_call_flops(m, it["frames"], 5, it["steps"]) for it in SERVE_ITEMS)
    mfu = metrics.reader("serve.conformer_mfu").read(rec, ctx)
    assert mfu == pytest.approx(100 * flops / (1e-4 * 989e12))
    t = subsampled(2999)
    assert work.encoder_flops(m, 2999) > 12 * 6 * t * t * 512     # the attention alone
    rec.trace = Trace(window_s=1e-4, busy_s=8e-6, device_ops=ops[1:], launches=1, top_ops=[],
                      idle_gaps=[])
    assert metrics.reader("relpos_attention_roofline.serve").read(rec, ctx) is None
    ctx.cfg = {"model": dict(m, encoder="transformer")}
    assert metrics.reader("serve.conformer_mfu").read(rec, ctx) is None


@pytest.mark.chip
def test_control_and_faults_fail_at_the_cells_size(cuda):
    """The control and the CTC state that does not follow its parent, at
    one seed, read above the cell's limits. The altered token and the
    relative offset off by one are readings only: the altered token fails
    ``prune_gap_mean`` on each calibration seed but with little room
    (0.108-0.163 against 0.1), and the offset reads 0.006-0.059 in
    ``score_gap_mean``, inside the port's own spread (adjacent rows of the
    sinusoidal table are close, so the shifted position term moves the
    scores little); both are printed."""
    files = manifest.context_files(manifest.load(), CELL)
    for what in ("control", "ctc", "fault", "offset"):
        ctx = Context(cell=CELL, config=files["config"], mix=files["mix"],
                      limits=files["limits"], seed=4242, seconds=0.0, trace=False,
                      device=cuda, t_start=0.0)
        nums = calibrate_conformer.reading(ctx, what)
        print(what, nums)
        if what in ("control", "ctc"):
            assert any(v > files["limits"][k] for k, v in nums.items()), (what, nums)
