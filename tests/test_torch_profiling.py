"""Port ``utils/profiling.py`` on the CPU: ``trace`` writes a Chrome trace
with the program's spans; with no profiler running ``named_scope`` is one
shared context that does nothing and imports nothing; the spans of a
served call form the decode path's tree, one step span per step run;
``device_ops`` leaves out the user annotations the profiler mirrors onto
the device's timeline; ``span_stats`` puts each runtime call in its
innermost span and follows its correlation id to the device time it
caused."""

import contextlib
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.autograd.profiler_util import FunctionEvent  # noqa: E402

from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.features import extract_features  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.decoding import (  # noqa: E402
    beam_decode, greedy_decode)
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.utils.profiling import (  # noqa: E402
    device_ops, named_scope, span_stats, trace)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 7


def test_trace_writes_a_chrome_trace_with_named_scopes(tmp_path):
    with trace(str(tmp_path / "logs"), name="step") as prof:
        with named_scope("decode_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "logs" / "step.json"
    assert path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "decode_step" for e in events)
    assert "decode_step" in {e.name for e in prof.events()}


def test_named_scope_without_a_profiler_is_one_shared_no_op():
    first, second = named_scope("st.a"), named_scope("st.b")
    assert first is second and isinstance(first, contextlib.nullcontext)
    with first, second:
        pass
    # The serving path's check imports nothing: torch._dynamo costs seconds.
    code = ("import sys, torch\n"
            "from speech_tranformer_pytorch_tpu_torch.utils.profiling import named_scope\n"
            "for _ in range(3):\n"
            "    with named_scope('st.x'):\n"
            "        torch.ones(2) + 1\n"
            "print('torch._dynamo' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


@pytest.fixture(scope="module")
def served():
    cfg = get_config("tiny")
    params = SpeechTransformer(cfg.model).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    audio, lens = make_utterances(2, min_seconds=0.8, max_seconds=1.2, seed=3)
    return cfg, Recognizer(cfg, params, device="cpu"), audio, lens


def _spans(prof):
    """(start ns, end ns, name) of every ``st.`` span, by start."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("st."))


def _inside(spans, outer):
    return [sp for sp in spans if outer[0] <= sp[0] and sp[1] <= outer[1] and sp != outer]


@pytest.mark.parametrize("beam", [5, 1])
def test_served_call_spans_form_the_decode_tree(served, beam, tmp_path):
    _, rec, audio, lens = served
    with trace(str(tmp_path), name="serve") as prof:
        rec.decode_result(audio, lens, beam_size=beam, max_len=MAX_LEN, alpha=1.0)
    spans = _spans(prof)
    named = lambda n: [sp for sp in spans if sp[2] == n]
    (call,) = named("st.recognize")
    assert len(_inside(spans, call)) == len(spans) - 1     # one call holds them all
    steps = named("st.decode.step")
    assert rec.last_steps > 0 and len(steps) == rec.last_steps
    for n in ("st.features", "st.encode", "st.decode.init_cache", "st.decode.finalize"):
        assert len(named(n)) == 1, n
    order = [named(n)[0] for n in ("st.features", "st.encode", "st.decode.init_cache")]
    order += steps + named("st.decode.finalize")
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    for step in steps:
        kids = sorted(n for _, _, n in _inside(spans, step))
        assert kids in (["st.decode.forward", "st.decode.search"],
                        ["st.decode.forward", "st.decode.search", "st.decode.stop"])
    stops = named("st.decode.stop")       # early stop: a test before every step
    assert len(stops) == rec.last_steps + (rec.last_steps < MAX_LEN)
    assert stops[0][1] <= steps[0][0]
    stats = span_stats(prof.profiler.kineto_results.events())
    assert {n: s.count for n, s in stats.items()} == {
        n: len(named(n)) for n in {sp[2] for sp in spans}}
    assert stats["st.decode.step"].host_s == pytest.approx(
        sum(e - s for s, e, _ in steps) / 1e9)


@pytest.mark.parametrize("beam", [5, 1])
def test_fixed_trip_decode_runs_no_stop_test(served, beam):
    cfg, rec, audio, lens = served
    feats, frame_lens = extract_features(audio, lens, cfg.features, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if beam == 1:
            result = greedy_decode(rec.model, feats, frame_lens, max_len=MAX_LEN,
                                   device="cpu", early_stop=False)
        else:
            result = beam_decode(rec.model, feats, frame_lens, beam_size=beam,
                                 max_len=MAX_LEN, device="cpu", early_stop=False)
    counts = {n: s.count for n, s in span_stats(prof.profiler.kineto_results.events()).items()}
    assert result.steps == MAX_LEN
    assert counts == {"st.encode": 1, "st.decode.init_cache": 1,
                      "st.decode.step": MAX_LEN, "st.decode.forward": MAX_LEN,
                      "st.decode.search": MAX_LEN, "st.decode.finalize": 1}


class _Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_device_ops_leave_out_user_annotations():
    ev = lambda i, name, s, e, **kw: FunctionEvent(i, name, thread=1, start_us=s, end_us=e,
                                                  **kw)
    cuda = dict(device_type=DeviceType.CUDA)
    events = [ev(0, "aten::mm", 0, 4),
              ev(1, "gemm", 2, 10, **cuda), ev(2, "copy", 8, 14, **cuda),
              ev(3, "fill", 30, 31, **cuda),
              ev(4, "st.decode.step", 0, 100, is_user_annotation=True, **cuda)]
    ops, busy = device_ops(_Profile(events))
    assert [e.name for e in ops] == ["gemm", "copy", "fill"]
    assert busy == 13.0


class _Kineto:
    """The part of ``torch._C._autograd._KinetoEvent`` ``span_stats`` reads."""

    def __init__(self, name, start, dur, *, thread=1, corr=0, device=False,
                 annotation=False):
        self._v = (name, start, dur, thread, corr, device, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_type(self):
        return DeviceType.CUDA if self._v[5] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[6]


def test_span_stats_puts_calls_in_the_innermost_span_and_follows_correlation():
    k = _Kineto
    launch = "cudaLaunchKernel"
    events = [
        k("st.outer", 0, 100), k("st.inner", 10, 40), k("st.outer", 200, 50),
        k("aten::mm", 12, 5, corr=2),                # a CPU op's own id: not a call
        k(launch, 5, 1, corr=1),                     # outer
        k(launch, 20, 1, corr=2),                    # inner
        k("cudaMemcpyAsync", 30, 2, corr=3),         # inner, not a launch
        k(launch, 60, 1, corr=4),                    # outer again, inner has ended
        k(launch, 150, 1, corr=5),                   # between the spans
        k(launch, 220, 1, corr=6),                   # the second outer
        k(launch, 20, 1, thread=2, corr=7),          # another thread: no span
        k("gemm", 300, 3, corr=1, device=True), k("gemm", 310, 4, corr=2, device=True),
        k("memcpy", 320, 5, corr=3, device=True), k("fill", 330, 6, corr=4, device=True),
        k("gemm", 340, 7, corr=5, device=True), k("gemm", 350, 8, corr=6, device=True),
        k("gemm", 360, 9, corr=7, device=True), k("gemm", 370, 10, corr=8, device=True),
        k("st.inner", 300, 1000, corr=2, device=True, annotation=True),   # a mirror
    ]
    stats = span_stats(events)
    assert set(stats) == {"st.outer", "st.inner", ""}
    outer, inner, none = stats["st.outer"], stats["st.inner"], stats[""]
    assert (outer.count, outer.host_s, outer.launches) == (2, 150e-9, 3)
    assert outer.device_s == pytest.approx((3 + 6 + 8) * 1e-9)
    assert (inner.count, inner.host_s, inner.launches) == (1, 40e-9, 1)
    assert inner.device_s == pytest.approx((4 + 5) * 1e-9)
    assert (none.count, none.launches) == (0, 2)
    assert none.device_s == pytest.approx((7 + 9 + 10) * 1e-9)
    assert sum(s.device_s for s in stats.values()) == pytest.approx(52e-9)
