"""Port audio I/O, FLAC codec and corpus preparation against the JAX
package's ``data/prepare.py`` and ``data/flac.py``: ``read_audio`` returns
identical samples and rates for WAV, ``.npy`` and FLAC (fixed and LPC
subframes, 24-bit, stereo) written by either package, in both dtypes;
``write_flac`` writes identical bytes; a corrupt stream raises
``FlacError``; ``prepare_synthetic``, ``prepare_librispeech`` and
``prepare_aishell`` write identical audio, vocabularies and manifests
(paths aside); the download stages run over ``file://`` URLs."""

import glob
import json
import os
import tarfile

import numpy as np
import pytest

pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.data import flac as jflac  # noqa: E402
from speech_tranformer_pytorch_tpu.data import prepare as jprep  # noqa: E402
from speech_tranformer_pytorch_tpu_torch import prepare_cli  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data import flac as pflac  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data import prepare as pprep  # noqa: E402
from tests.test_data import _make_librispeech_fixture  # noqa: E402


def _tone(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (3000 * np.sin(0.03 * t) + 500 * np.sin(0.31 * t)
            + rng.normal(0, 50, n)).astype(np.int16).astype(np.int32)


FLAC_CASES = {
    "auto": (_tone(9000), {}),
    "lpc": (_tone(9000, 1), dict(subframe_mode="lpc")),
    "fixed2": (_tone(9000, 2), dict(subframe_mode="fixed2")),
    "fixed4": (_tone(5000, 3), dict(subframe_mode="fixed4")),
    "bps24": ((_tone(6000, 4) * 200).astype(np.int32), dict(bps=24)),
    "stereo": (np.stack([_tone(7000, 5), _tone(7000, 6) // 2], 1), {}),
    "stereo_lpc": (np.stack([_tone(5000, 7), _tone(5000, 7) // 3], 1),
                   dict(subframe_mode="lpc")),
}


@pytest.mark.parametrize("case", sorted(FLAC_CASES))
def test_flac_bytes_and_read_audio_match(case, tmp_path):
    x, kw = FLAC_CASES[case]
    jpath, ppath = str(tmp_path / "j.flac"), str(tmp_path / "p.flac")
    jflac.write_flac(jpath, x, 16000, **kw)
    pflac.write_flac(ppath, x, 16000, **kw)
    data = open(ppath, "rb").read()
    assert data == open(jpath, "rb").read()
    pcm, rate, bps = pflac.decode_flac(ppath)
    want = jflac.decode_flac_py(data)
    np.testing.assert_array_equal(pcm, want[0])
    assert (rate, bps) == want[1:]
    np.testing.assert_array_equal(pcm, x if x.ndim == 2 else x[:, None])
    assert pflac.flac_info(ppath) == jflac.flac_info(jpath)
    for path in (jpath, ppath):
        for dtype in ("float32", "int16"):
            got, got_rate = pprep.read_audio(path, dtype=dtype)
            ref, ref_rate = jprep.read_audio(path, dtype=dtype)
            assert got.dtype == ref.dtype and got_rate == ref_rate
            np.testing.assert_array_equal(got, ref)


def test_wav_and_npy_read_audio_match(tmp_path):
    wave = (np.random.default_rng(0).standard_normal(12345) * 0.2).astype(np.float32)
    jw, pw = str(tmp_path / "j.wav"), str(tmp_path / "p.wav")
    jprep.write_wav(jw, wave, 16000)
    pprep.write_wav(pw, wave, 16000)
    assert open(pw, "rb").read() == open(jw, "rb").read()
    npy = str(tmp_path / "a.npy")
    np.save(npy, np.clip(wave * 4, -1.5, 1.5))
    for path in (pw, npy):
        for dtype in ("float32", "int16"):
            got, got_rate = pprep.read_audio(path, dtype=dtype)
            ref, ref_rate = jprep.read_audio(path, dtype=dtype)
            assert got.dtype == ref.dtype and got_rate == ref_rate
            np.testing.assert_array_equal(got, ref)


def test_corrupt_flac_raises(tmp_path):
    f = str(tmp_path / "a.flac")
    pflac.write_flac(f, _tone(5000), 16000)
    data = bytearray(open(f, "rb").read())
    data[len(data) // 2] ^= 0xFF
    with pytest.raises(pflac.FlacError):
        pflac.decode_flac(bytes(data))
    with pytest.raises(pflac.FlacError):
        pflac.decode_flac_py(b"RIFF" + bytes(data[4:]))
    with pytest.raises(pflac.FlacError):
        pflac.flac_info(b"RIFF" + bytes(data[4:]))


def _manifest(path, root):
    """A manifest's entries with ``root`` cut from their audio paths."""
    out = []
    for e in pprep.read_manifest(path):
        out.append(dict(e, audio=os.path.relpath(e["audio"], root)))
    return out


def _same_outputs(jout, pout, jroot, proot):
    assert set(jout) == set(pout)
    assert open(pout["vocab"], "rb").read() == open(jout["vocab"], "rb").read()
    for split in set(jout) - {"vocab"}:
        assert _manifest(pout[split], proot) == _manifest(jout[split], jroot), split


def test_prepare_synthetic_matches(tmp_path):
    kw = dict(num_train=5, num_dev=2, num_test=3, vocab_size=20, seed=3)
    jd, pd = str(tmp_path / "j"), str(tmp_path / "p")
    jout, pout = jprep.prepare_synthetic(jd, **kw), pprep.prepare_synthetic(pd, **kw)
    _same_outputs(jout, pout, jd, pd)
    wavs = sorted(os.listdir(os.path.join(pd, "wav")))
    assert wavs == sorted(os.listdir(os.path.join(jd, "wav"))) and len(wavs) == 10
    for w in wavs:
        assert (open(os.path.join(pd, "wav", w), "rb").read()
                == open(os.path.join(jd, "wav", w), "rb").read())


@pytest.fixture(scope="module")
def librispeech(tmp_path_factory):
    root = tmp_path_factory.mktemp("ls")
    return _make_librispeech_fixture(root, n_train=6, n_dev=2, n_test=2)


def test_prepare_librispeech_matches(librispeech, tmp_path):
    corpus, _ = librispeech
    kw = dict(train_splits=("train-clean-100",), bpe_vocab_size=48)
    jout = jprep.prepare_librispeech(corpus, str(tmp_path / "j"), **kw)
    pout = pprep.prepare_librispeech(corpus, str(tmp_path / "p"), **kw)
    _same_outputs(jout, pout, corpus, corpus)
    assert json.load(open(pout["vocab"]))["type"] == "bpe"
    for e in pprep.read_manifest(pout["train"])[:2]:
        samples, rate = pprep.read_audio(e["audio"], dtype="int16")
        assert len(samples) == e["num_samples"] and rate == e["sample_rate"]


def _aishell_tree(root):
    """The AISHELL-1 layout of tests/test_data.py's fixture, tiny WAVs."""
    rng = np.random.default_rng(0)
    texts = {"BAC009S0002W0122": "绿 是 阳春", "BAC009S0002W0123": "烟 景 大",
             "BAC009S0724W0121": "块 文章", "BAC009S0764W0121": "的 底色"}
    splits = {"train": ["BAC009S0002W0122", "BAC009S0002W0123"],
              "dev": ["BAC009S0724W0121"], "test": ["BAC009S0764W0121"]}
    for split, ids in splits.items():
        for uid in ids:
            d = root / "wav" / split / uid[6:11]
            d.mkdir(parents=True, exist_ok=True)
            pprep.write_wav(str(d / f"{uid}.wav"),
                            (rng.standard_normal(8000) * 0.1).astype(np.float32))
    (root / "transcript").mkdir(parents=True)
    (root / "transcript" / "aishell_transcript_v0.8.txt").write_text(
        "\n".join(f"{u} {t}" for u, t in texts.items()), encoding="utf-8")
    return str(root)


def test_prepare_aishell_matches(tmp_path):
    corpus = _aishell_tree(tmp_path / "data_aishell")
    jout = jprep.prepare_aishell(corpus, str(tmp_path / "j"))
    pout = pprep.prepare_aishell(corpus, str(tmp_path / "p"))
    _same_outputs(jout, pout, corpus, corpus)
    assert len(pprep.read_manifest(pout["train"])) == 2


def test_download_aishell_over_file_url(tmp_path):
    """The nested release layout: data_aishell/{transcript, wav/S*.tar.gz}."""
    stage = tmp_path / "stage" / "data_aishell"
    _aishell_tree(stage)
    wav = stage / "wav"
    for spk in ("S0002", "S0724", "S0764"):
        with tarfile.open(wav / f"{spk}.tar.gz", "w:gz") as tf:
            for split_dir in sorted(wav.iterdir()):
                if split_dir.is_dir() and (split_dir / spk).is_dir():
                    tf.add(split_dir / spk, arcname=f"{split_dir.name}/{spk}")
    for split_dir in [p for p in wav.iterdir() if p.is_dir()]:
        import shutil
        shutil.rmtree(split_dir)
    release = tmp_path / "data_aishell.tgz"
    with tarfile.open(release, "w:gz") as tf:
        tf.add(stage, arcname="data_aishell")
    dest, out = tmp_path / "corpus", tmp_path / "data"
    prepare_cli.main(["aishell", "--download", "--device", "cpu",
                      "--url", f"file://{release}", "--corpus", str(dest),
                      "--out", str(out)])
    assert len(pprep.read_manifest(str(out / "train.jsonl"))) == 2
    assert not glob.glob(str(dest / "data_aishell" / "wav" / "*.tar.gz"))
    again = pprep.download_aishell(str(dest), url="file:///nonexistent.tgz")
    assert again == str(dest / "data_aishell")


def test_download_librispeech_over_file_url(librispeech, tmp_path):
    corpus, utts = librispeech
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    for split in ("train-clean-100", "dev-clean", "test-clean"):
        with tarfile.open(mirror / f"{split}.tar.gz", "w:gz") as tf:
            tf.add(os.path.join(corpus, split), arcname=f"LibriSpeech/{split}")
    dest, out = tmp_path / "corpus", tmp_path / "data"
    prepare_cli.main(["librispeech", "--download", "--device", "cpu",
                      "--url-base", f"file://{mirror}", "--corpus", str(dest),
                      "--out", str(out),
                      "--train-splits", "train-clean-100", "--bpe-vocab-size", "48"])
    assert len(pprep.read_manifest(str(out / "train.jsonl"))) == len(
        utts["train-clean-100"])
    assert (dest / "LibriSpeech" / "dev-clean").is_dir()
    assert not list(dest.glob("*.tar.gz"))
    again = pprep.download_librispeech(str(dest), ["dev-clean"],
                                       url_base="file:///nonexistent")
    assert again == str(dest / "LibriSpeech")


def test_safe_extract_rejects_traversal(tmp_path):
    evil = tmp_path / "evil.tgz"
    payload = tmp_path / "p.txt"
    payload.write_text("x")
    with tarfile.open(evil, "w:gz") as tf:
        tf.add(payload, arcname="../../escape.txt")
    with pytest.raises(Exception):
        pprep._safe_extract_tar(str(evil), str(tmp_path / "out"))
    assert not (tmp_path.parent / "escape.txt").exists()
