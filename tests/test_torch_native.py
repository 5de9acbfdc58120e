"""The port's native host libraries (``native/``) against their pure-Python
versions and the JAX package's ``ops/metrics.py`` and ``data/flac.py``.

- Edit distance, ``cer`` and ``wer``: the native route, ``force_python``
  and the JAX package give identical distances, errors and rates on seeded
  token and word corpora (empty sequences included).
- FLAC: over every encoder mode of ``tests/test_data.py``'s
  ``TestFlacCodec`` cases, the native decode is bit-equal to
  ``force_python``, to the written PCM and to the JAX decoder (both of its
  routes); a corrupt stream raises ``FlacError`` on every route; a stream
  whose STREAMINFO gives no sample count is decoded in Python, as in JAX.
- Each native call is counted; a build that cannot compile raises with
  the compiler's output instead of falling back to Python."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.data import flac as jflac  # noqa: E402
from speech_tranformer_pytorch_tpu.ops import metrics as jmetrics  # noqa: E402
from speech_tranformer_pytorch_tpu_torch import native  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data import flac  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.ops import metrics  # noqa: E402


def _corpus(seed, n=40, vocab=12, max_len=30):
    rng = np.random.default_rng(seed)
    refs, hyps = [], []
    for i in range(n):
        ref = rng.integers(0, vocab, size=int(rng.integers(0, max_len))).tolist()
        hyp = list(ref)
        for _ in range(int(rng.integers(0, 6))):      # edits of every kind
            op, pos = int(rng.integers(3)), int(rng.integers(len(hyp) + 1))
            if op == 0:
                hyp.insert(pos, int(rng.integers(vocab)))
            elif hyp and pos < len(hyp):
                if op == 1:
                    del hyp[pos]
                else:
                    hyp[pos] = int(rng.integers(vocab))
        if i % 9 == 4:
            hyp = []
        refs.append(ref)
        hyps.append(hyp)
    return refs, hyps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edit_distance_and_cer_match(seed):
    refs, hyps = _corpus(seed)
    for r, h in zip(refs, hyps):
        want = jmetrics._edit_distance_py(r, h)
        assert metrics.edit_distance(r, h) == want
        assert metrics.edit_distance(r, h, force_python=True) == want
        assert jmetrics.edit_distance(r, h) == want
    got = metrics.cer(refs, hyps)
    assert got == metrics.cer(refs, hyps, force_python=True) == jmetrics.cer(refs, hyps)
    assert got["errors"] > 0 and got["ref_tokens"] == sum(map(len, refs))
    assert metrics.cer([], []) == jmetrics.cer([], []) == {
        "cer": 0.0, "errors": 0.0, "ref_tokens": 0.0}
    with pytest.raises(ValueError, match="differ in count"):
        metrics.cer(refs, hyps[:-1])


def test_wer_matches():
    refs, hyps = _corpus(3, vocab=7)
    words = "the a cat sat on mat dog".split()
    rw = [[words[i] for i in r] for r in refs]
    hw = [[words[i] for i in h] for h in hyps]
    got = metrics.wer(rw, hw)
    assert got == metrics.wer(rw, hw, force_python=True) == jmetrics.wer(rw, hw)
    assert got["wer"] > 0


def test_native_calls_are_counted(tmp_path):
    native.reset_call_counts()
    metrics.cer([[1, 2, 3]], [[1, 3]])
    metrics.cer([[1, 2, 3]], [[1, 3]], force_python=True)
    metrics.edit_distance([1, 2], [2])
    path = str(tmp_path / "a.flac")
    flac.write_flac(path, _tone(3000), 16000)
    flac.decode_flac(path)
    flac.decode_flac(path, force_python=True)
    assert native.call_counts() == {"edit_distance_i32": 1,
                                    "edit_distance_corpus_i32": 1, "flac_decode": 1}
    native.reset_call_counts()
    assert set(native.call_counts().values()) == {0}


def _tone(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (3000 * np.sin(0.03 * t) + 500 * np.sin(0.31 * t)
            + rng.normal(0, 50, n)).astype(np.int16).astype(np.int32)


def _flac_cases():
    """The cases of ``tests/test_data.py::TestFlacCodec::test_roundtrip_all_modes``."""
    tone = _tone(30000)
    rng = np.random.default_rng(1)
    cases = {f"m_{m}": (tone, dict(subframe_mode=m))
             for m in ("auto", "lpc", "fixed0", "fixed2", "fixed4", "verbatim")}
    cases.update({
        "constant": (np.full(9000, -123, np.int32), dict(subframe_mode="constant")),
        "noise_escape": (rng.integers(-32768, 32767, 15000).astype(np.int32), {}),
        "odd_tail": (tone[:4097], {}),
        "short": (tone[:100], {}),
        "stereo": (np.stack([tone[:8000], tone[:8000] // 2], 1), {}),
        "bps8": ((tone[:6000] // 256).astype(np.int32), dict(bps=8)),
        "bps24": ((tone[:6000] * 200).astype(np.int32), dict(bps=24)),
        "rate_code": (tone[:4000], {}),
    })
    return cases


FLAC_CASES = _flac_cases()


@pytest.mark.parametrize("name", sorted(FLAC_CASES))
def test_flac_decode_matches_python_and_jax(name, tmp_path):
    x, kw = FLAC_CASES[name]
    path = str(tmp_path / f"{name}.flac")
    flac.write_flac(path, x, 16000, **kw)
    want = x if x.ndim == 2 else x[:, None]
    native.reset_call_counts()
    got, rate, bps = flac.decode_flac(path)
    assert native.call_counts()["flac_decode"] == 1
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for decoded in (flac.decode_flac(path, force_python=True),
                    flac.decode_flac(open(path, "rb").read()),
                    jflac.decode_flac(path), jflac.decode_flac(path, force_python=True)):
        np.testing.assert_array_equal(decoded[0], got)
        assert decoded[1:] == (rate, bps) == (16000, kw.get("bps", 16))


def test_flac_without_sample_count_is_decoded_in_python(tmp_path):
    """STREAMINFO's 36-bit sample count (bytes 21-25 after the 4-byte magic
    and 4-byte block header) set to 0: the native decoder needs it to size
    its output, so the stream goes to Python, as in the JAX package."""
    path = str(tmp_path / "a.flac")
    x = _tone(5000)
    flac.write_flac(path, x, 16000)
    data = bytearray(open(path, "rb").read())
    data[21] &= 0xF0
    data[22:26] = bytes(4)
    assert flac.flac_info(bytes(data))[0] == 0
    native.reset_call_counts()
    got = flac.decode_flac(bytes(data))
    assert native.call_counts()["flac_decode"] == 0
    np.testing.assert_array_equal(got[0][:, 0], x)
    np.testing.assert_array_equal(jflac.decode_flac(bytes(data))[0], got[0])


def test_corrupt_flac_raises_on_every_route(tmp_path):
    path = str(tmp_path / "a.flac")
    flac.write_flac(path, _tone(5000), 16000)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF       # a flipped bit mid-frame
    for decode in (flac.decode_flac, jflac.decode_flac,
                   lambda d: flac.decode_flac(d, force_python=True)):
        with pytest.raises(flac.FlacError if decode is not jflac.decode_flac
                           else jflac.FlacError):
            decode(bytes(data))
    with pytest.raises(flac.FlacError, match="not a FLAC"):
        flac.decode_flac(b"RIFF" + bytes(data[4:]))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source the compiler rejects raises with the compiler's message;
    a compiler that is missing raises too. Neither falls back to Python."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "editdistance.cc").write_text("extern \"C\" int broken( { }\n")
    monkeypatch.setattr(native, "SOURCE_DIR", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="failed to build editdistance.cc") as e:
        metrics.cer([[1, 2]], [[1]])
    assert "error" in str(e.value)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run the C\\+\\+ compiler"):
        metrics.edit_distance([1], [2])
    assert metrics.cer([[1, 2]], [[1]], force_python=True)["errors"] == 1.0
