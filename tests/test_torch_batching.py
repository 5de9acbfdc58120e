"""Port manifest batching against the JAX package's ``data/pipeline.py``:
``ManifestDataset`` keeps and drops the same entries; ``plan_epoch`` gives
identical plans over seeds, epochs, shuffling, remainders, frame budgets
and one or two shards; every batch of an epoch has identical audio,
lengths, targets (adaptive widths included) and ``valid`` flags, padding
rows of remainder batches included; ``skip_batches`` gives the tail of the
full epoch. The corpus mixes WAV and FLAC files, lengths across four
buckets, targets of 1-40 tokens, and entries each filter drops."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import (  # noqa: E402
    DataConfig as JDataConfig, FeatureConfig as JFeatureConfig)
from speech_tranformer_pytorch_tpu.data import pipeline as jpipe  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import DataConfig, FeatureConfig  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data import pipeline as ppipe  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.flac import write_flac  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.prepare import (  # noqa: E402
    write_manifest, write_wav)

BOUNDARIES = (40, 60, 80, 110)
DATA = dict(max_source_frames=110, max_target_len=48, bucket_boundaries=BOUNDARIES)
FIELDS = ("audio", "sample_lens", "targets_in", "targets_out", "target_lens", "valid")


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """26 utterances of 0.02-1.3 s: every fourth a FLAC file; one too short
    for a frame, three longer than 110 frames, two with 48+ tokens."""
    root = tmp_path_factory.mktemp("batching")
    rng = np.random.default_rng(0)
    n_samples = list(rng.integers(3500, 17500, size=20)) + [300, 19000, 20000, 25000,
                                                             8000, 9000]
    n_tokens = list(rng.integers(1, 41, size=20)) + [3, 4, 5, 6, 48, 60]
    entries = []
    for i, (n, k) in enumerate(zip(n_samples, n_tokens)):
        wave = 0.3 * np.sin(0.05 * np.arange(n)) + 0.01 * rng.standard_normal(n)
        if i % 4 == 3:
            path = str(root / f"u{i:02d}.flac")
            write_flac(path, np.round(wave * 32767).astype(np.int32), 16000)
        else:
            path = str(root / f"u{i:02d}.wav")
            write_wav(path, wave.astype(np.float32))
        entries.append({"utt_id": f"u{i:02d}", "audio": path, "num_samples": int(n),
                        "sample_rate": 16000, "text": "",
                        "tokens": rng.integers(4, 60, size=int(k)).tolist()})
    path = str(root / "m.jsonl")
    write_manifest(path, entries)
    return path


@pytest.fixture(scope="module")
def datasets(manifest):
    return (jpipe.ManifestDataset(manifest, JDataConfig(**DATA), JFeatureConfig()),
            ppipe.ManifestDataset(manifest, DataConfig(**DATA), FeatureConfig()))


def test_dataset_filters_match(datasets):
    jds, pds = datasets
    assert pds.dropped == jds.dropped == 6
    assert pds.entries == jds.entries
    assert len(pds) == len(jds) == 20
    assert pds.audio_dtype == jds.audio_dtype == "int16"


def _plan(mod, ds, **kw):
    return [(p.bucket, p.global_idxs, p.pad_to_batch) for p in mod.plan_epoch(ds, **kw)]


@pytest.mark.parametrize("seed,epoch,shuffle,drop,frames,shards", [
    c for c in itertools.product((0, 5), (0, 1), (True, False), (True, False),
                                 (0, 240), (1, 2))
    if c[0] == 0 or (c[2] and not c[3])])
def test_plan_epoch_matches(datasets, seed, epoch, shuffle, drop, frames, shards):
    jds, pds = datasets
    sizes = ([max(frames // b, 1) for b in BOUNDARIES] if frames else [3] * len(BOUNDARIES))
    kw = dict(boundaries=BOUNDARIES, bucket_batch_sizes=sizes, num_shards=shards,
              seed=seed, epoch_index=epoch, shuffle=shuffle, drop_remainder=drop)
    plan = _plan(ppipe, pds, **kw)
    assert plan == _plan(jpipe, jds, **kw)
    assert plan


def _batchers(datasets, **kw):
    jds, pds = datasets
    return jpipe.BucketedBatcher(jds, **kw), ppipe.BucketedBatcher(pds, **kw)


def _assert_batches_equal(jbatches, pbatches):
    jbatches, pbatches = list(jbatches), list(pbatches)
    assert len(pbatches) == len(jbatches) > 0
    for jb, pb in zip(jbatches, pbatches):
        if isinstance(pb, tuple):
            (jb, jrows), (pb, prows) = jb, pb
            assert prows == jrows
        for f in FIELDS:
            got, want = getattr(pb, f), np.asarray(getattr(jb, f))
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            assert got.numpy().dtype == want.dtype, f
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


BATCHER_CASES = {
    "train": dict(batch_size=3, seed=1, drop_remainder=True),
    "eval_remainder": dict(batch_size=4, shuffle=False, drop_remainder=False),
    "frame_budget": dict(batch_size=0, seed=2, drop_remainder=False,
                         max_frames_per_batch=240),
    "fixed_width": dict(batch_size=3, seed=3, drop_remainder=False,
                        adaptive_target_len=False),
    "shard0of2": dict(batch_size=2, seed=4, drop_remainder=False, num_shards=2,
                      shard_index=0),
    "shard1of2": dict(batch_size=2, seed=4, drop_remainder=False, num_shards=2,
                      shard_index=1),
}


@pytest.mark.parametrize("case", sorted(BATCHER_CASES))
def test_epoch_batches_match(datasets, case):
    kw = dict(BATCHER_CASES[case], bucket_boundaries=BOUNDARIES, target_len=48)
    jb, pb = _batchers(datasets, **kw)
    for epoch in (0, 1):
        _assert_batches_equal(jb.epoch(epoch, with_rows=True),
                              pb.epoch(epoch, with_rows=True))
    widths = {b.targets_in.shape[1] for b in pb.epoch(0)}
    if kw.get("adaptive_target_len", True):
        assert len(widths) > 1 and all(w % 16 == 0 for w in widths)
    else:
        assert widths == {48}
    if not kw.get("drop_remainder", True):
        assert any(not bool(b.valid.all()) for b in pb.epoch(0))


def test_padding_rows(datasets):
    _, pb = _batchers(datasets, batch_size=4, shuffle=False, drop_remainder=False,
                      bucket_boundaries=BOUNDARIES, target_len=48)
    pads = 0
    for b in pb.epoch(0):
        for row in np.nonzero(~b.valid.numpy())[0]:
            pads += 1
            assert int(b.sample_lens[row]) == FeatureConfig().frame_length
            assert int(b.target_lens[row]) == 1
            assert int(b.targets_in[row, 0]) == 1 and int(b.targets_out[row, 0]) == 2
            assert not bool(b.audio[row].any())
    assert pads > 0


def test_skip_batches_gives_the_tail(datasets):
    _, pb = _batchers(datasets, batch_size=3, seed=1, drop_remainder=False,
                      bucket_boundaries=BOUNDARIES, target_len=48)
    full = list(pb.epoch(1, with_rows=True))
    for skip in (0, 2, len(full) - 1, len(full)):
        tail = list(pb.epoch(1, skip_batches=skip, with_rows=True))
        assert len(tail) == len(full) - skip
        for (b, rows), (fb, frows) in zip(tail, full[skip:]):
            assert rows == frows
            for f in FIELDS:
                assert torch.equal(getattr(b, f), getattr(fb, f))


def test_target_width_for_rows_matches(datasets):
    jds, pds = datasets
    for rows in ([0], [1, 2, 3], list(range(len(pds)))):
        for target_len in (8, 16, 33, 48):
            for adaptive in (True, False):
                assert (ppipe.target_width_for_rows(pds, rows, target_len,
                                                    adaptive=adaptive)
                        == jpipe.target_width_for_rows(jds, rows, target_len,
                                                       adaptive=adaptive))
