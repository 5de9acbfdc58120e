"""The Whisper serving cell (``drivers/serve_whisper.py``,
``reference/whisper.py``, ``calibrate_whisper.py``, ``work/whisper.py`` and
its two readers): on the CPU at a tiny Whisper-shaped float32 size, a
sound run reads rounding, and the fp8 control, the prompt's rows left out
of the steps and the shifted prune each make ``correct`` false; a port
without Whisper's fields is refused before anything is built; the
manifest lists the cell in the workloads of the metrics it reports, and the
readers count a recorded run. On the chip (``-m chip``) the control and
the prompt fault read above the cell's committed limits."""

import types

import numpy as np
import pytest
import torch

from portbench import calibrate, calibrate_whisper, manifest, metrics, run
from portbench.drivers import serve_whisper
from portbench.harness import Context, Record
from portbench.peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S
from portbench.reference.model import Precision
from portbench.trace import Trace
from portbench.work import whisper as work
from portbench.work.cross import serve_bound_s
from portbench.work.model import subsampled

from .conftest import tiny_mix

CELL = "whisper.serve.long-b16"
LIMITS = {"score_gap_mean": 1e-4, "prune_gap_mean": 1e-3}


def whisper_config() -> dict:
    from speech_tranformer_pytorch_tpu_torch.config import get_config

    cfg = get_config("whisper_large_v3").to_dict()
    cfg["model"].update(d_model=32, num_heads=4, d_ff=64, num_encoder_layers=2,
                        num_decoder_layers=2, vocab_size=40, input_dim=16,
                        max_source_positions=1500, max_target_positions=32, dtype="float32")
    cfg["features"].update(num_mel_bins=16, output_dtype="float32")
    cfg["data"].update(max_target_len=32, bucket_boundaries=[100, 200, 300, 512],
                       max_source_frames=512)
    cfg["decode"].update(prompt=[1, 5, 6, 7], suppress=[0, 1, 8, 9, 10, 11],
                         suppress_first=[2, 12])
    return cfg


def whisper_mix() -> dict:
    return dict(tiny_mix("serve"), entry="serve_whisper", trace_items=4, check_calls=4)


def whole_run(seed=2 ** 31 + 23, trace=0):
    """``run.run_cell`` of the cell on the CPU at the tiny size; an untraced
    window serves every batch of the pool at least once (as a calibration
    reading does), so the check draws from as many calls however slowly
    the CPU serves them."""
    bench = manifest.load()
    mix = whisper_mix()
    files = {"workload": manifest.workload(bench, CELL),
             "config": {"config": whisper_config()}, "mix": mix, "limits": LIMITS}
    args = types.SimpleNamespace(workload=CELL, seed=seed, seconds=0.3, trace=trace)
    real = serve_whisper.run
    serve_whisper.run = lambda ctx, **kw: real(ctx, min_items=mix["check_calls"], **kw)
    try:
        return run.run_cell(bench, files, args, torch.device("cpu"), 0.0)
    finally:
        serve_whisper.run = real


def numbers(out) -> dict:
    return {c["name"]: c["value"] for c in out["checks"]}


def test_a_sound_run_reads_rounding():
    out = whole_run(trace=1)
    got = numbers(out)
    assert out["correct"] is True, got
    assert got["score_gap_mean"] < 1e-5 and got["prune_gap_mean"] < 1e-4


def test_the_fp8_control_is_not_correct(monkeypatch):
    real = serve_whisper.check
    monkeypatch.setattr(serve_whisper, "check",
                        lambda ctx, pool, items, calls, control=None: real(
                            ctx, pool, items, calls, Precision("fp8")))
    out = whole_run()
    assert out["correct"] is False
    assert numbers(out)["score_gap_mean"] > 10 * LIMITS["score_gap_mean"]


@pytest.mark.parametrize("fault", ["prompt", "prune"])
def test_the_prompt_left_out_and_the_shifted_prune_are_not_correct(fault):
    with {"prompt": calibrate_whisper.prompt_left_out, "prune": calibrate.shifted_prune}[fault]():
        out = whole_run()
    assert out["correct"] is False, numbers(out)


def test_a_port_without_the_whisper_fields_is_refused(monkeypatch):
    import dataclasses

    from speech_tranformer_pytorch_tpu_torch import config

    ctx = types.SimpleNamespace(cfg=whisper_config())
    serve_whisper.check_fields(ctx.cfg)
    whole = config.ExperimentConfig()
    older = dataclasses.make_dataclass(
        "FeatureConfig", [(f.name, f.type, f) for f in dataclasses.fields(config.FeatureConfig)
                          if f.name != "kind"])
    parent = types.SimpleNamespace(**{f.name: getattr(whole, f.name)
                                      for f in dataclasses.fields(whole)})
    parent.features = older()
    monkeypatch.setattr(config, "ExperimentConfig", lambda: parent)
    with pytest.raises(RuntimeError, match="features.kind"):
        serve_whisper.run(ctx)


def test_the_manifest_lists_the_cell_where_its_metrics_read():
    bench = manifest.load()
    assert manifest.validate(bench) == []
    w = manifest.workload(bench, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("whisper", "serve.whisper-30s-b16", 1)
    got = {m["name"] for m in manifest.metrics_of(bench, CELL, "per_layer")}
    assert got == {"serve.device_idle_share", "serve.launches_per_decode_step",
                   "lineage_roofline.serve", "cross_attention_roofline.serve",
                   "serve.whisper_mfu", "serve.whisper_roofline"}
    e2e = {m["name"] for m in manifest.metrics_of(bench, CELL, "end_to_end")}
    assert e2e == {"setup_s", "serve_audio_s_per_s", "serve_p95_s", "peak_mem_gib"}


def test_the_readers_count_a_recorded_run():
    from speech_tranformer_pytorch_tpu_torch.config import get_config

    cfg = get_config("whisper_large_v3").to_dict()
    m = cfg["model"]
    tokens = np.random.default_rng(0).integers(4, 50000, (2, 5, 6))
    items = [dict(batch=0, wall_s=0.5, audio_s=40.0, steps=6, b=2, beam=5, enc_frames=1500,
                  frames=[4 * 1500 + 3] * 2, max_len=6, tokens=tokens)]
    ops = [("cross_attention_decode_kernel", 0, 4_000_000), ("gemm", 3_000_000, 9_000_000)]
    trace = Trace(window_s=0.01, busy_s=9e-3, device_ops=ops, launches=20, top_ops=[],
                  idle_gaps=[])
    rec = Record(kind="serve", setup_s=1.0, window_s=1.0, items=items, peak_bytes=0,
                 attempted=1, failed=0, numbers={}, trace=trace)
    ctx = types.SimpleNamespace(cfg=cfg)
    # The existing cross-attention reader counts 1,500 frames an utterance.
    assert subsampled(items[0]["frames"][0]) == 1500
    assert metrics.reader("cross_attention_roofline.serve").read(rec, ctx) == pytest.approx(
        100 * serve_bound_s(m, items[0]["frames"], 5, 6) / 4e-3)
    # The prologue: stem, 32 encoder layers at t 1500, 64 cross projections,
    # the prompt's first 3 tokens; compute-bound.
    d, t = 1280, 1500
    layer = 2 * t * d * 3 * d + 4 * t * t * d + 2 * t * d * d + 4 * t * d * 5120
    flops, nbytes = work.prologue_counts(cfg, 2, t)
    assert flops > 2 * (32 * layer + 32 * 2 * t * d * 2 * d)
    assert flops / BF16_FLOP_PER_S > nbytes / HBM_BYTES_PER_S
    # A step: the decoder's weights but the cross K/V once, the cross cache of
    # both utterances, the tied table; bandwidth-bound.
    f1, b1 = work.step_counts(cfg, 2, 5, t, 3, 0)
    assert b1 == 32 * (6 * d * d + 2 * d * 5120) * 2 + 32 * 2 * 2 * t * d * 2 \
        + 51866 * d * 2 + 10 * 51866 * 4
    assert b1 / HBM_BYTES_PER_S > f1 / BF16_FLOP_PER_S
    bound = work.call_bound_s(cfg, items[0])
    assert metrics.reader("serve.whisper_roofline").read(rec, ctx) == pytest.approx(
        100 * bound / 9e-3)
    assert metrics.reader("serve.whisper_mfu").read(rec, ctx) == pytest.approx(
        100 * work.call_flops(cfg, items[0]) / (0.01 * BF16_FLOP_PER_S))
    ctx.cfg = dict(cfg, features=dict(cfg["features"], kind="kaldi"))
    assert metrics.reader("serve.whisper_mfu").read(rec, ctx) is None
    assert metrics.reader("serve.whisper_roofline").read(rec, ctx) is None


@pytest.mark.chip
def test_control_and_prompt_fault_fail_at_the_cells_size(cuda):
    """The fp8 control and the prompt's rows left out, at one seed, read
    above the cell's committed limits; the altered token and the shifted
    prune are printed for the record."""
    files = manifest.context_files(manifest.load(), CELL)
    for what in ("control", "prompt", "fault", "prune"):
        ctx = Context(cell=CELL, config=files["config"], mix=files["mix"],
                      limits=files["limits"], seed=4242, seconds=0.0, trace=False,
                      device=cuda, t_start=0.0)
        nums = calibrate_whisper.reading(ctx, what)
        print(what, nums)
        if what in ("control", "prompt"):
            assert any(v > files["limits"][k] for k, v in nums.items()), (what, nums)
