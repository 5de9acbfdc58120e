"""The comparison that decides ``correct`` fails what it must: the
control (the precision below the configuration's, in the port's place)
and every fault a cell can have, planted under a whole run.

On the CPU at a tiny float32 size, with limits of this size (the sound
runs read float32 rounding); on the chip (``-m chip``) at each cell's own
size against its committed limits."""

import types

import pytest
import torch

from portbench import calibrate, manifest, run
from portbench.harness import Context
from portbench.reference.model import Precision

from .conftest import tiny_config, tiny_mix

LIMITS = {"score_gap_mean": 1e-4, "prune_gap_mean": 1e-3,
          "loss_gap": 1e-4, "grad_gap": 1e-2, "change_gap": 5e-2}
CELLS = {"serve": "base.serve.aishell-b8", "train": "base.train.tiny"}


def whole_run(entry, monkeypatch=None, dtype="float32", seed=2 ** 31 + 3, trace=0, mix=None):
    """``run.run_cell`` on the CPU (the look for a chip skipped). Training
    has no cell in BENCHMARK.json, so it runs as a cell of its own."""
    bench = manifest.load()
    cfg = tiny_config(dtype)
    cell = {"name": CELLS[entry], "config": "base", "traffic": "tiny", "chips": 1, "why": "tiny"}
    if entry == "serve":
        cell = manifest.workload(bench, CELLS[entry])
    files = {"workload": cell, "config": {"config": cfg}, "mix": mix or tiny_mix(entry),
             "limits": LIMITS}
    args = types.SimpleNamespace(workload=CELLS[entry], seed=seed, seconds=0.3, trace=trace)
    return run.run_cell(bench, files, args, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_sound_runs_are_correct(entry):
    assert whole_run(entry)["correct"] is True


def test_fp8_serving_control_is_not_correct(monkeypatch):
    from portbench.drivers import serve

    real = serve.check
    monkeypatch.setattr(serve, "check", lambda ctx, pool, items, calls, control=None: real(
        ctx, pool, items, calls, Precision("fp8")))
    out = whole_run("serve")
    assert out["correct"] is False
    assert out["checks"][0]["value"] > 10 * LIMITS["score_gap_mean"]


def test_the_ports_int8_path_is_not_correct(monkeypatch):
    from portbench.drivers import serve

    real = serve.build
    monkeypatch.setattr(serve, "build", lambda ctx, overrides=None: real(ctx, calibrate.INT8))
    assert whole_run("serve")["correct"] is False


def test_fp8_training_control_fails_a_number():
    ctx = Context(cell="tiny", config={"config": tiny_config()}, mix=tiny_mix("train"),
                  limits=LIMITS, seed=7, seconds=0.0, trace=False, device=torch.device("cpu"),
                  t_start=0.0)
    nums = calibrate.reading(ctx, "control")
    assert any(nums[k] > LIMITS[k] for k in nums)


def test_an_altered_token_is_not_correct(monkeypatch):
    from portbench.drivers import serve

    real = serve.serve

    def altered(rec, hb, decode):
        out, steps = real(rec, hb, decode)
        return calibrate.alter_token(out, tiny_config()["model"]["vocab_size"]), steps

    monkeypatch.setattr(serve, "serve", altered)
    assert whole_run("serve")["correct"] is False


def test_a_prune_that_drops_the_best_candidate_is_not_correct():
    """The prune keeps ranks 2 to k2 + 1: every served score still adds up
    (``score_gap_mean`` stays at rounding), the prune numbers fail."""
    mix = dict(tiny_mix("serve"), trace_items=4, check_calls=4)   # the same calls every time
    with calibrate.shifted_prune():
        out = whole_run("serve", trace=1, mix=mix)
    got = {c["name"]: c["value"] for c in out["checks"]}
    assert out["correct"] is False
    assert got["score_gap_mean"] < LIMITS["score_gap_mean"]
    assert got["prune_gap_mean"] > 100 * LIMITS["prune_gap_mean"]


def _wrap_step(monkeypatch, wrap):
    from speech_tranformer_pytorch_tpu_torch.data import pipeline

    real = pipeline.make_audio_train_step
    monkeypatch.setattr(pipeline, "make_audio_train_step", lambda cfg: wrap(real(cfg)))


def test_a_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    def wrap(step):
        def unchanged(state, batch, seed=0):
            keep = {k: v.detach().clone() for k, v in state.params.items()}
            mu = {k: v.clone() for k, v in state.opt.mu.items()}
            nu = {k: v.clone() for k, v in state.opt.nu.items()}
            new, met = step(state, batch, seed)
            with torch.no_grad():
                for k, v in new.params.items():
                    v.copy_(keep[k])
            for k in mu:
                new.opt.mu[k].copy_(mu[k])
                new.opt.nu[k].copy_(nu[k])
            return new, met
        return unchanged

    _wrap_step(monkeypatch, wrap)
    out = whole_run("train")
    assert out["correct"] is False
    assert {c["name"]: c["value"] for c in out["checks"]}["change_gap"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from speech_tranformer_pytorch_tpu_torch.data.pipeline import AudioBatch

    def wrap(step):
        def half(state, batch, seed=0):
            n = batch.audio.shape[0] // 2
            return step(state, AudioBatch(*(getattr(batch, f)[:n] for f in
                                            AudioBatch.__dataclass_fields__)), seed)
        return half

    _wrap_step(monkeypatch, wrap)
    assert whole_run("train")["correct"] is False


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load()["workloads"]])
def test_control_and_fault_fail_at_the_cells_size(cuda, cell):
    files = manifest.context_files(manifest.load(), cell)
    for what in ("control", "fault") + (("prune",) if files["mix"]["entry"] == "serve" else ()):
        ctx = Context(cell=cell, config=files["config"], mix=files["mix"],
                      limits=files["limits"], seed=4242, seconds=0.0, trace=False,
                      device=cuda, t_start=0.0)
        nums = calibrate.reading(ctx, what)
        assert any(v > files["limits"][k] for k, v in nums.items()), (what, nums)
