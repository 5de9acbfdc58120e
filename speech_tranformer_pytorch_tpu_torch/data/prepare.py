"""Corpus preparation and audio I/O (counterpart of the JAX package's
``data/prepare.py``): walk a corpus, join transcripts, build the
vocabulary and write per-split manifests.

Manifest format: JSONL, one utterance per line:
  {"utt_id": ..., "audio": "<path .wav|.flac|.npy>", "num_samples": N,
   "sample_rate": R, "text": ..., "tokens": [ids]}

WAV goes through the stdlib ``wave`` module (16-bit PCM), FLAC through
``data/flac.py``. ``prepare_synthetic`` writes a tone corpus, so the whole
file-based stack runs with no corpus. Every function writes the same bytes
as its JAX counterpart.
"""

from __future__ import annotations

import json
import os
import wave
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .tokenizer import CharTokenizer, normalize_text


# ---------------------------------------------------------------------------
# Audio I/O (stdlib only)
# ---------------------------------------------------------------------------

def read_audio(path: str, dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """Read .wav (16-bit mono PCM), .flac or .npy (float32 at 16 kHz).
    Returns (samples, sample_rate).

    ``dtype='int16'`` returns the raw PCM samples (``data.audio_dtype``):
    the fbank dequantizes them by 1/32768 on the device, so WAV features
    equal the float32 path's bit for bit. .npy float sources are quantized
    through int16 (the ``write_wav`` convention) in that mode. FLAC decodes
    through ``data/flac.py``; stereo is averaged to mono, and other depths
    are shifted onto the 16-bit scale."""
    if path.endswith(".flac"):
        from .flac import decode_flac
        pcm, rate, bps = decode_flac(path)
        if pcm.shape[1] > 1:
            pcm = np.mean(pcm, axis=1).astype(np.int32)[:, None]
        pcm = pcm[:, 0]
        if bps != 16:        # normalize depth onto the 16-bit transport
            shift = bps - 16
            pcm = (pcm >> shift) if shift > 0 else (pcm << -shift)
        if dtype == "int16":
            return pcm.astype(np.int16), rate
        return pcm.astype(np.float32) / 32768.0, rate
    if path.endswith(".npy"):
        arr = np.load(path, allow_pickle=False)
        if dtype == "int16":
            return (np.clip(arr, -1.0, 1.0) * 32767.0).astype(np.int16), 16000
        return arr.astype(np.float32), 16000
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: only 16-bit mono PCM is supported")
        rate = w.getframerate()
        data = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
    if dtype == "int16":
        return data, rate
    return (data.astype(np.float32) / 32768.0), rate


def write_wav(path: str, samples: np.ndarray, sample_rate: int = 16000) -> None:
    pcm = np.clip(samples, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


# ---------------------------------------------------------------------------
# Manifests
# ---------------------------------------------------------------------------

def write_manifest(path: str, entries: Iterable[Dict]) -> int:
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for e in entries:
            f.write(json.dumps(e, ensure_ascii=False) + "\n")
            n += 1
    return n


def read_manifest(path: str) -> List[Dict]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# OpenSLR resource 33: the AISHELL-1 release.
AISHELL_URL = "https://www.openslr.org/resources/33/data_aishell.tgz"


def _safe_extract_tar(archive: str, dest: str) -> None:
    """Extract a tarball, refusing path-traversal members."""
    import tarfile
    with tarfile.open(archive, "r:*") as tf:
        try:
            tf.extractall(dest, filter="data")   # py>=3.12 traversal guard
        except TypeError:                        # older tarfile: check by hand
            base = os.path.realpath(dest)

            def inside(p: str) -> bool:
                rp = os.path.realpath(p)
                return rp == base or rp.startswith(base + os.sep)

            members = tf.getmembers()
            for m in members:
                if not inside(os.path.join(dest, m.name)):
                    raise ValueError(f"unsafe tar member {m.name!r}")
                # Links can escape even with a clean member name: a symlink
                # pointing outside dest followed by a member written through
                # it (filter='data' rejects these on 3.12+).
                if m.issym() or m.islnk():
                    link = m.linkname
                    if m.issym() and not os.path.isabs(link):
                        link = os.path.join(dest, os.path.dirname(m.name), link)
                    elif m.islnk():
                        link = os.path.join(dest, link)
                    if not inside(link):
                        raise ValueError(
                            f"unsafe tar link {m.name!r} -> {m.linkname!r}")
            # Extract one member at a time, re-resolving the parent dir so a
            # member written through an earlier in-archive symlink still
            # cannot land outside dest.
            for m in members:
                if not inside(os.path.join(dest, os.path.dirname(m.name))):
                    raise ValueError(f"unsafe tar member path {m.name!r}")
                tf.extract(m, dest)


def download_aishell(
    dest_dir: str,
    *,
    url: str = AISHELL_URL,
    extract: bool = True,
    keep_inner_archives: bool = False,
) -> str:
    """Fetch and untar ``data_aishell.tgz``, then every per-speaker
    ``wav/*.tar.gz`` inside it (the OpenSLR release nests them). Skips the
    download when the tarball or the extracted tree is present, so an
    interrupted run re-enters cleanly. Returns ``<dest_dir>/data_aishell``,
    the root ``prepare_aishell`` takes. The tests run it over a ``file://``
    URL."""
    import glob
    import urllib.request

    os.makedirs(dest_dir, exist_ok=True)
    corpus_root = os.path.join(dest_dir, "data_aishell")
    tarball = os.path.join(dest_dir, os.path.basename(url) or "corpus.tgz")
    if not os.path.isdir(corpus_root):
        if not os.path.exists(tarball):
            tmp = tarball + ".part"
            urllib.request.urlretrieve(url, tmp)
            os.replace(tmp, tarball)
        if extract:
            # Extract to a scratch dir and os.replace into place (mirroring
            # the .part download pattern) so an interrupted extraction can
            # never leave a partial data_aishell/ that later re-entries
            # mistake for a complete corpus tree.
            import shutil
            scratch = os.path.join(dest_dir, ".extract_tmp")
            if os.path.isdir(scratch):
                shutil.rmtree(scratch)
            os.makedirs(scratch)
            _safe_extract_tar(tarball, scratch)
            extracted = os.path.join(scratch, os.path.basename(corpus_root))
            if not os.path.isdir(extracted):
                raise FileNotFoundError(
                    f"archive did not contain {os.path.basename(corpus_root)}/")
            os.replace(extracted, corpus_root)
            shutil.rmtree(scratch)
    if extract:
        # Per-speaker inner archives: wav/{train,dev,test} trees live
        # inside S*.tar.gz files relative to the wav/ dir.
        for inner in sorted(glob.glob(
                os.path.join(corpus_root, "wav", "*.tar.gz"))):
            _safe_extract_tar(inner, os.path.join(corpus_root, "wav"))
            if not keep_inner_archives:
                os.remove(inner)
    return corpus_root


def prepare_aishell(
    corpus_dir: str,
    out_dir: str,
    *,
    min_count: int = 1,
) -> Dict[str, str]:
    """AISHELL-1 layout: ``wav/{train,dev,test}/SSSS/BAC...wav`` +
    ``transcript/aishell_transcript_v0.8.txt`` (utt-id text per line).
    Builds char vocab from train transcripts; emits per-split manifests.
    Returns {"vocab": path, "train": path, "dev": path, "test": path}.
    """
    os.makedirs(out_dir, exist_ok=True)
    trans_path = None
    for root, _, files in os.walk(os.path.join(corpus_dir, "transcript")):
        for fn in files:
            if fn.endswith(".txt"):
                trans_path = os.path.join(root, fn)
    if trans_path is None:
        raise FileNotFoundError(f"no transcript .txt under {corpus_dir}/transcript")

    transcripts: Dict[str, str] = {}
    with open(trans_path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) == 2:
                transcripts[parts[0]] = parts[1]

    splits: Dict[str, List[Tuple[str, str]]] = {}
    for split in ("train", "dev", "test"):
        split_dir = os.path.join(corpus_dir, "wav", split)
        utts = []
        for root, _, files in os.walk(split_dir):
            for fn in sorted(files):
                if fn.endswith(".wav"):
                    utt_id = os.path.splitext(fn)[0]
                    if utt_id in transcripts:
                        utts.append((utt_id, os.path.join(root, fn)))
        splits[split] = utts

    tok = CharTokenizer.train(
        (transcripts[u] for u, _ in splits.get("train", [])),
        min_count=min_count)
    vocab_path = os.path.join(out_dir, "vocab.json")
    tok.save(vocab_path)

    out = {"vocab": vocab_path}
    for split, utts in splits.items():
        def entries():
            for utt_id, wav in utts:
                samples, rate = read_audio(wav)
                text = normalize_text(transcripts[utt_id])
                yield {"utt_id": utt_id, "audio": wav,
                       "num_samples": int(len(samples)),
                       "sample_rate": int(rate), "text": text,
                       "tokens": tok.encode(text)}
        mpath = os.path.join(out_dir, f"{split}.jsonl")
        n = write_manifest(mpath, entries())
        out[split] = mpath
        print(f"{split}: {n} utterances -> {mpath}")
    return out


# OpenSLR resource 12 — the LibriSpeech release (per-split tarballs, each
# containing LibriSpeech/{split}/{speaker}/{chapter}/...).
LIBRISPEECH_URL_BASE = "https://www.openslr.org/resources/12"
LIBRISPEECH_TRAIN_SPLITS = ("train-clean-100", "train-clean-360",
                            "train-other-500")


def download_librispeech(
    dest_dir: str,
    splits: Iterable[str],
    *,
    url_base: str = LIBRISPEECH_URL_BASE,
) -> str:
    """Download + untar LibriSpeech splits (OpenSLR 12; one tarball per
    split, each expanding to ``LibriSpeech/<split>/...``). Re-entry safe
    the same way as :func:`download_aishell`: .part downloads, scratch-dir
    extraction + ``os.replace`` into place, and completed splits are
    skipped. Returns the corpus root (``<dest_dir>/LibriSpeech``) — pass
    it to :func:`prepare_librispeech`.

    The tests run it over ``file://`` URLs."""
    import shutil
    import urllib.request

    os.makedirs(dest_dir, exist_ok=True)
    corpus_root = os.path.join(dest_dir, "LibriSpeech")
    os.makedirs(corpus_root, exist_ok=True)
    for split in splits:
        split_dir = os.path.join(corpus_root, split)
        if os.path.isdir(split_dir):
            continue
        tarball = os.path.join(dest_dir, f"{split}.tar.gz")
        if not os.path.exists(tarball):
            tmp = tarball + ".part"
            urllib.request.urlretrieve(f"{url_base}/{split}.tar.gz", tmp)
            os.replace(tmp, tarball)
        scratch = os.path.join(dest_dir, f".extract_tmp_{split}")
        if os.path.isdir(scratch):
            shutil.rmtree(scratch)
        os.makedirs(scratch)
        _safe_extract_tar(tarball, scratch)
        extracted = os.path.join(scratch, "LibriSpeech", split)
        if not os.path.isdir(extracted):
            raise FileNotFoundError(
                f"{split}.tar.gz did not contain LibriSpeech/{split}/")
        os.replace(extracted, split_dir)
        shutil.rmtree(scratch)
        os.remove(tarball)
    return corpus_root


def _walk_librispeech_split(split_dir: str) -> List[Tuple[str, str, str]]:
    """Walk ``<split>/<speaker>/<chapter>/`` and join each utterance's
    .flac with its line in the chapter's ``<spk>-<chap>.trans.txt``
    (format: ``<utt-id> THE UPPERCASE TRANSCRIPT``). Returns sorted
    (utt_id, flac_path, text)."""
    out: List[Tuple[str, str, str]] = []
    for root, _, files in sorted(os.walk(split_dir)):
        trans = [f for f in files if f.endswith(".trans.txt")]
        if not trans:
            continue
        texts: Dict[str, str] = {}
        for t in trans:
            with open(os.path.join(root, t), encoding="utf-8") as f:
                for line in f:
                    parts = line.strip().split(maxsplit=1)
                    if len(parts) == 2:
                        texts[parts[0]] = parts[1]
        for fn in sorted(files):
            if fn.endswith(".flac"):
                utt_id = os.path.splitext(fn)[0]
                if utt_id in texts:
                    out.append((utt_id, os.path.join(root, fn),
                                texts[utt_id]))
    return sorted(out)


def prepare_librispeech(
    corpus_dir: str,
    out_dir: str,
    *,
    train_splits: Iterable[str] = LIBRISPEECH_TRAIN_SPLITS,
    dev_splits: Iterable[str] = ("dev-clean",),
    test_splits: Iterable[str] = ("test-clean",),
    bpe_vocab_size: int = 5000,
) -> Dict[str, str]:
    """LibriSpeech layout: ``<split>/<speaker>/<chapter>/<utt>.flac`` +
    per-chapter ``*.trans.txt`` (the 960 h train set is the union of the
    three train splits). Trains a BPE tokenizer on the train transcripts
    and writes per-split JSONL manifests whose ``audio`` entries are the
    .flac paths. Utterance lengths come from STREAMINFO (no decode pass).
    Returns {"vocab": path, "train": path, "dev": path, "test": path}.
    """
    from .flac import flac_info
    from .tokenizer import BpeTokenizer

    if os.path.isdir(os.path.join(corpus_dir, "LibriSpeech")):
        corpus_dir = os.path.join(corpus_dir, "LibriSpeech")
    os.makedirs(out_dir, exist_ok=True)

    def gather(splits):
        utts = []
        for s in splits:
            d = os.path.join(corpus_dir, s)
            if not os.path.isdir(d):
                raise FileNotFoundError(f"missing LibriSpeech split {d}")
            utts.extend(_walk_librispeech_split(d))
        return utts

    groups = {"train": gather(train_splits), "dev": gather(dev_splits),
              "test": gather(test_splits)}

    tok = BpeTokenizer.train((t for _, _, t in groups["train"]),
                             bpe_vocab_size)
    vocab_path = os.path.join(out_dir, "vocab.json")
    tok.save(vocab_path)

    out = {"vocab": vocab_path}
    for split, utts in groups.items():
        def entries():
            for utt_id, flac_path, text in utts:
                total, rate, _, _ = flac_info(flac_path)
                text_n = " ".join(text.upper().split())
                yield {"utt_id": utt_id, "audio": flac_path,
                       "num_samples": int(total), "sample_rate": int(rate),
                       "text": text_n, "tokens": tok.encode(text_n)}
        mpath = os.path.join(out_dir, f"{split}.jsonl")
        n = write_manifest(mpath, entries())
        out[split] = mpath
        print(f"{split}: {n} utterances -> {mpath}")
    return out


def prepare_synthetic(
    out_dir: str,
    *,
    num_train: int = 32,
    num_dev: int = 8,
    num_test: int = 8,
    vocab_size: int = 32,
    seed: int = 0,
) -> Dict[str, str]:
    """Write a synthetic tone corpus (``data/synthetic.make_synthetic_dataset``)
    as WAV files, manifests and a char vocabulary."""
    from .synthetic import make_synthetic_dataset

    os.makedirs(os.path.join(out_dir, "wav"), exist_ok=True)
    counts = {"train": num_train, "dev": num_dev, "test": num_test}
    n_total = sum(counts.values())
    ds = make_synthetic_dataset(n_total, vocab_size=vocab_size, seed=seed)

    # Fake "characters": map token id -> a CJK codepoint so the char
    # tokenizer path is exercised exactly like AISHELL.
    id2char = {i: chr(0x4E00 + i) for i in range(4, vocab_size)}
    texts = ["".join(id2char[t] for t in tr) for tr in ds.transcripts]
    tok = CharTokenizer.train(texts)

    out = {}
    idx = 0
    vocab_path = os.path.join(out_dir, "vocab.json")
    tok.save(vocab_path)
    out["vocab"] = vocab_path
    for split, n in counts.items():
        def entries():
            nonlocal idx
            for _ in range(n):
                utt_id = f"SYN{idx:05d}"
                wav = os.path.join(out_dir, "wav", f"{utt_id}.wav")
                write_wav(wav, ds.waves[idx], ds.sample_rate)
                text = texts[idx]
                yield {"utt_id": utt_id, "audio": wav,
                       "num_samples": int(len(ds.waves[idx])),
                       "sample_rate": ds.sample_rate, "text": text,
                       "tokens": tok.encode(text)}
                idx += 1
        mpath = os.path.join(out_dir, f"{split}.jsonl")
        write_manifest(mpath, entries())
        out[split] = mpath
    return out
