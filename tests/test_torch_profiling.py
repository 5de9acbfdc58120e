"""Port ``utils/profiling.py`` on the CPU: ``trace`` writes a Chrome trace,
a ``named_scope`` shows among the profiler's events, ``StepTimer`` counts
steps, audio and tokens, and ``sync`` returns the first element."""

import json
import time

import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu_torch.utils.profiling import (  # noqa: E402
    StepTimer, named_scope, sync, trace)


def test_trace_writes_a_chrome_trace_with_named_scopes(tmp_path):
    with trace(str(tmp_path / "logs"), name="step") as prof:
        with named_scope("decode_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "logs" / "step.json"
    assert path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "decode_step" for e in events)
    assert "decode_step" in {e.name for e in prof.events()}


def test_step_timer_rates():
    timer = StepTimer()
    for _ in range(3):
        timer.record(audio_seconds=2.0, tokens=10)
    time.sleep(0.01)
    r = timer.rates(sync_on=torch.ones(2))
    assert set(r) == {"steps_per_s", "audio_sps", "tokens_per_s", "wall_s"}
    assert r["wall_s"] > 0
    assert r["audio_sps"] == pytest.approx(6.0 / r["wall_s"], rel=1e-6)
    assert r["tokens_per_s"] == pytest.approx(30.0 / r["wall_s"], rel=1e-6)
    assert r["steps_per_s"] == pytest.approx(3.0 / r["wall_s"], rel=1e-6)
    timer.reset()
    assert timer.rates()["steps_per_s"] == 0.0


def test_sync_returns_the_first_element_as_a_float():
    value = sync(torch.tensor([[3.5, 1.0]], dtype=torch.bfloat16))
    assert isinstance(value, float) and value == 3.5
