"""The port's worker-pool pipeline (``data/grain_pipeline.py``,
``data.pipeline="grain"``) against the port's ``BucketedBatcher`` and the
JAX package's ``GrainBucketedPipeline``.

The corpus mixes WAV and FLAC files over four buckets. Every batch of an
epoch (audio, lengths, targets, adaptive widths, ``valid``) is identical
across the three pipelines, for training, evaluation remainders, frame
budgets, fixed widths and two shards, with the port's pool at 0 and 2
worker processes (the JAX side reads with grain's threads; its batches
do not depend on its workers). Also held, as ``tests/test_data.py``'s
``TestGrainPipeline`` holds the JAX pipeline: runs repeat and epochs
differ; shards partition every epoch and yield equally many batches over
1-4 shards; ``skip_batches`` gives the tail with no reads of the skipped
batches; ``bucket_batch_sizes`` written after construction are honoured.
A worker's error reaches the caller, and an epoch left early stops its
workers; ``chip_smoke.py``'s exit stops the fork server and the resource
tracker before the process ends, and stops and reports any other child
left running. A tiny-preset ``Trainer`` with ``pipeline="grain"`` trains bit
for bit as with ``pipeline="python"``."""

import multiprocessing

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import (  # noqa: E402
    DataConfig as JDataConfig, FeatureConfig as JFeatureConfig)
from speech_tranformer_pytorch_tpu.data import pipeline as jpipe  # noqa: E402
from speech_tranformer_pytorch_tpu.data.grain_pipeline import (  # noqa: E402
    GrainBucketedPipeline as JaxGrain)
from speech_tranformer_pytorch_tpu_torch import config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import DataConfig, FeatureConfig  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data import grain_pipeline, pipeline  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.flac import write_flac  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.grain_pipeline import (  # noqa: E402
    GrainBucketedPipeline)
from speech_tranformer_pytorch_tpu_torch.data.prepare import (  # noqa: E402
    prepare_synthetic, write_manifest, write_wav)
from speech_tranformer_pytorch_tpu_torch.runner import Trainer  # noqa: E402

BOUNDARIES = (40, 60, 80, 110)
DATA = dict(max_source_frames=110, max_target_len=48, bucket_boundaries=BOUNDARIES)
FIELDS = ("audio", "sample_lens", "targets_in", "targets_out", "target_lens", "valid")


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """20 usable utterances of 0.2-1.1 s, every third a FLAC file."""
    root = tmp_path_factory.mktemp("grain")
    rng = np.random.default_rng(3)
    entries = []
    for i, (n, k) in enumerate(zip(rng.integers(3500, 17500, size=20),
                                   rng.integers(1, 41, size=20))):
        wave = 0.3 * np.sin(0.05 * np.arange(n)) + 0.01 * rng.standard_normal(n)
        if i % 3 == 2:
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
            pipeline.ManifestDataset(manifest, DataConfig(**DATA), FeatureConfig()))


def _equal(a, b):
    """Two lists of batches (port tensors or JAX arrays) are identical."""
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for f in FIELDS:
            u, v = np.asarray(getattr(x, f)), np.asarray(getattr(y, f))
            assert u.dtype == v.dtype and u.shape == v.shape, f
            np.testing.assert_array_equal(u, v, err_msg=f)


CASES = {
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


@pytest.mark.parametrize("case,workers", [(c, 0) for c in sorted(CASES)]
                         + [("train", 2), ("shard1of2", 2)])
def test_batches_match_batcher_and_jax(datasets, case, workers):
    jds, pds = datasets
    kw = dict(CASES[case], bucket_boundaries=BOUNDARIES, target_len=48)
    ours = GrainBucketedPipeline(pds, num_workers=workers, **kw)
    batcher = pipeline.BucketedBatcher(pds, **kw)
    jax_grain = JaxGrain(jds, **kw)
    epochs = (1,) if workers else (0, 1)
    for epoch in epochs:
        got = list(ours.epoch(epoch))
        assert all(isinstance(getattr(b, f), torch.Tensor) for b in got for f in FIELDS)
        _equal(got, batcher.epoch(epoch))
        _equal(got, jax_grain.epoch(epoch))
    if case == "frame_budget":
        assert ours.bucket_batch_sizes == [240 // b for b in BOUNDARIES]
        assert len({b.audio.shape[0] for b in ours.epoch(0)}) > 1


def test_runs_repeat_and_epochs_differ(datasets):
    _, pds = datasets
    pipe = GrainBucketedPipeline(pds, batch_size=3, bucket_boundaries=BOUNDARIES,
                                 target_len=48, seed=5)
    sig = lambda e: [b.sample_lens.tolist() for b in pipe.epoch(e)]
    assert sig(0) == sig(0)
    assert sig(0) != sig(1)


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_shards_partition_with_equal_batch_counts(datasets, shards):
    _, pds = datasets
    seen, counts = [], []
    for shard in range(shards):
        pipe = GrainBucketedPipeline(pds, batch_size=2, bucket_boundaries=BOUNDARIES,
                                     target_len=48, seed=6, shard_index=shard,
                                     num_shards=shards, drop_remainder=False)
        batches = list(pipe.epoch(0))
        counts.append(len(batches))
        for b in batches:
            seen += [b.audio[r].numpy().tobytes() for r in range(b.audio.shape[0])
                     if bool(b.valid[r])]
    assert len(set(counts)) == 1, counts
    assert len(seen) == len(set(seen)) == len(pds)


@pytest.mark.parametrize("workers", [0, 2])
def test_skip_batches_reads_only_the_tail(datasets, workers, monkeypatch):
    _, pds = datasets
    kw = dict(batch_size=3, bucket_boundaries=BOUNDARIES, target_len=48, seed=1,
              drop_remainder=False)
    full = list(GrainBucketedPipeline(pds, **kw).epoch(1))
    reads = []
    orig = grain_pipeline.ManifestReads.__getitem__
    if not workers:   # workers read in their own processes: counted in-process only
        monkeypatch.setattr(grain_pipeline.ManifestReads, "__getitem__",
                            lambda self, key: reads.append(key[0]) or orig(self, key))
    skip = 2
    tail = list(GrainBucketedPipeline(pds, num_workers=workers, **kw).epoch(
        1, skip_batches=skip))
    _equal(tail, full[skip:])
    if not workers:
        assert len(reads) == sum(int(b.valid.sum()) for b in full[skip:])


def test_bucket_batch_sizes_written_after_construction(datasets):
    _, pds = datasets
    kw = dict(batch_size=2, bucket_boundaries=BOUNDARIES, target_len=48, seed=2,
              drop_remainder=False)
    ours, batcher = GrainBucketedPipeline(pds, **kw), pipeline.BucketedBatcher(pds, **kw)
    for b in (ours, batcher):
        b.bucket_batch_sizes = [4, 3, 2, 1]
    got = list(ours.epoch(0))
    _equal(got, batcher.epoch(0))
    assert {b.audio.shape[0] for b in got} == {4, 3, 2, 1}


def test_worker_error_reaches_the_caller_and_workers_stop(datasets, tmp_path):
    _, pds = datasets
    kw = dict(batch_size=3, bucket_boundaries=BOUNDARIES, target_len=48, seed=1,
              num_workers=2)
    before = set(multiprocessing.active_children())
    it = GrainBucketedPipeline(pds, **kw).epoch(0)
    next(it)
    assert len(set(multiprocessing.active_children()) - before) == 2
    it.close()       # an epoch left early, as a max_steps stop leaves it
    assert set(multiprocessing.active_children()) <= before
    broken = pipeline.ManifestDataset.__new__(pipeline.ManifestDataset)
    broken.__dict__.update(pds.__dict__)
    broken.entries = [dict(e, audio=str(tmp_path / "missing.wav")) for e in pds.entries]
    with pytest.raises(FileNotFoundError):
        list(GrainBucketedPipeline(broken, **kw).epoch(0))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return prepare_synthetic(str(tmp_path_factory.mktemp("grain_trainer") / "c"),
                             num_train=12, num_dev=0, num_test=0, vocab_size=16, seed=2)


@pytest.mark.parametrize("workers", [0, 2])
def test_trainer_with_grain_equals_python(corpus, tmp_path, workers):
    """Five steps (two epochs of two batches, stopped mid-epoch) from the
    same init: every parameter and moment bit-equal."""
    over = {"model.vocab_size": 32, "model.d_model": 32, "model.num_heads": 2,
            "model.d_ff": 64, "model.num_encoder_layers": 1,
            "model.num_decoder_layers": 1, "model.dropout_rate": 0.1,
            "model.subsample_channels": 4, "train.batch_size": 5,
            "train.checkpoint_every_steps": 100, "train.log_every": 5,
            "data.num_workers": workers}
    states = {}
    before = set(multiprocessing.active_children())
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for pipe in ("python", "grain"):
            cfg = config.get_config("tiny", **dict(over, **{"data.pipeline": pipe}))
            tr = Trainer(cfg, work_dir=str(tmp_path / pipe), train_manifest=corpus["train"],
                         device="cpu")
            if pipe == "grain":
                assert isinstance(tr.batcher, GrainBucketedPipeline)
                assert tr.batcher.num_workers == workers
            states[pipe] = tr.train(max_steps=5)
    finally:
        torch.set_num_threads(threads)
    a, b = states["python"], states["grain"]
    assert a.step == b.step == 5
    for k, p in a.params.items():
        assert torch.equal(b.params[k], p), k
        assert torch.equal(b.opt.mu[k], a.opt.mu[k]), k
    assert set(multiprocessing.active_children()) <= before


def test_chip_smoke_stops_what_outlives_it(manifest):
    """In a child process: an epoch at 2 workers read and left early, and a
    stray ``sleep``; ``stop_started_processes`` reports the stray alone and
    leaves nothing below the process. The fork server and the resource
    tracker are gone, not merely ending, once the child has exited."""
    import json
    import os
    import subprocess
    import sys

    code = ("import json, multiprocessing.forkserver as fs, subprocess\n"
            "import multiprocessing.resource_tracker as rt\n"
            "import chip_smoke\n"
            "from speech_tranformer_pytorch_tpu_torch.config import DataConfig, FeatureConfig\n"
            "from speech_tranformer_pytorch_tpu_torch.data import pipeline\n"
            "from speech_tranformer_pytorch_tpu_torch.data.grain_pipeline import"
            " GrainBucketedPipeline\n"
            f"ds = pipeline.ManifestDataset({manifest!r}, DataConfig(**{DATA!r}),"
            " FeatureConfig())\n"
            f"it = GrainBucketedPipeline(ds, batch_size=3, bucket_boundaries={BOUNDARIES!r},"
            " target_len=48, num_workers=2).epoch(0)\n"
            "next(it)\n"
            "it.close()\n"
            "stray = subprocess.Popen(['sleep', '60'])\n"
            "helpers = [fs._forkserver._forkserver_pid, rt._resource_tracker._pid]\n"
            "leaked = chip_smoke.stop_started_processes()\n"
            "print(json.dumps({'helpers': helpers, 'leaked': leaked, 'stray': stray.pid,"
            " 'left': chip_smoke._descendants()}))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=300,
                         stdout=subprocess.PIPE, text=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert all(isinstance(pid, int) for pid in got["helpers"]), got
    assert got["leaked"] == [[got["stray"], "sleep 60"]]
    assert got["left"] == []
    assert not any(os.path.exists(f"/proc/{pid}") for pid in got["helpers"]), got


def test_port_imports_no_jax_or_grain():
    """Every module of the port, and ``chip_smoke.py``, imports with jax,
    flax, optax, orbax, grain and the JAX package made unimportable."""
    import os
    import subprocess
    import sys

    code = ("import importlib, pkgutil, sys\n"
            "for m in ('jax', 'flax', 'optax', 'orbax', 'grain',"
            " 'speech_tranformer_pytorch_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import speech_tranformer_pytorch_tpu_torch as p\n"
            "for mod in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(mod.name)\n"
            "import chip_smoke\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=300)
