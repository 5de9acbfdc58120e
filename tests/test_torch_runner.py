"""Port ``Trainer``, checkpoints and CLIs against the JAX package's
``runner.py``, ``utils/checkpoint.py`` and CLIs (small tiny-preset model,
CPU).

- Both ``Trainer``s train on the same synthetic manifest from the same
  JAX init (dropout 0, f32 compute and moments): each logged loss and
  grad norm agree at 1e-5 relative, accuracy and lr at 1e-6, dev loss at
  1e-5, dev greedy CER exactly, and every ``train_metrics.jsonl`` record
  has the same keys.
- Checkpoints: a save/restore round trip is exact (bf16 moments and the
  device count kept), retention keeps ``max_to_keep`` files, a missing
  checkpoint raises, and so does a model-hash mismatch on resume.
- Resume: a run stopped at step 3 and resumed is bit-identical to an
  uninterrupted 6-step run, with dropout on (its bits depend only on the
  seed and the step).
- Best-model tracking survives a restart; the hot loop reads its metrics
  once a log boundary, not once a step.
- The CLI flow on the CPU: prepare -> train -> resume (the saved config
  wins) -> recognize, with ``--checkpoint best`` after dev evals.
- ``model_hash`` / ``config_hash`` equal the JAX package's for every
  preset, so ``config_hash.txt`` compares across packages."""

import contextlib
import io
import json
import math
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu import config as jconfig  # noqa: E402
from speech_tranformer_pytorch_tpu import train as jtrain  # noqa: E402
from speech_tranformer_pytorch_tpu.runner import Trainer as JaxTrainer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch import (  # noqa: E402
    config, prepare_cli, recognize_cli, train_cli)
from speech_tranformer_pytorch_tpu_torch.convert import (  # noqa: E402
    adam_state_from_jax, params_from_jax)
from speech_tranformer_pytorch_tpu_torch.data.prepare import prepare_synthetic  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.runner import Trainer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.train import create_train_state  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.utils.checkpoint import (  # noqa: E402
    Checkpointer, CheckpointState)

SMALL = {"model.vocab_size": 32, "model.d_model": 32, "model.num_heads": 2,
         "model.d_ff": 64, "model.num_encoder_layers": 1,
         "model.num_decoder_layers": 1, "model.dropout_rate": 0.0,
         "model.subsample_channels": 4}
CLI_SMALL = [a for k, v in SMALL.items() if k != "model.vocab_size"
             for a in ("--set", f"{k}={v}")]


def _records(work_dir):
    with open(f"{work_dir}/train_metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return prepare_synthetic(str(tmp_path_factory.mktemp("runner") / "c"),
                             num_train=8, num_dev=4, num_test=0, vocab_size=16, seed=0)


@pytest.fixture(scope="module")
def parity(corpus, tmp_path_factory):
    """Both trainers, 4 steps (two epochs of two batches), dev evals at
    steps 2 and 4, from the JAX trainer's init. That init runs as one jit
    (one compile, where the eager flax init compiles each op); both
    trainers start from whatever it gives. The JAX logger is built with
    TensorFlow hidden, so it writes its JSONL records without the
    TensorBoard writer the port does not have (and without its import)."""
    tmp = tmp_path_factory.mktemp("parity")
    over = dict(SMALL, **{"train.batch_size": 4, "train.log_every": 1,
                          "train.eval_every_steps": 2,
                          "train.checkpoint_every_steps": 100,
                          "train.moment_dtype": "float32"})
    kw = dict(train_manifest=corpus["train"], dev_manifest=corpus["dev"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "init_params", jax.jit(jtrain.init_params, static_argnums=0))
        mp.setitem(sys.modules, "tensorflow", None)
        jtr = JaxTrainer(jconfig.get_config("tiny", **over), work_dir=str(tmp / "j"),
                         mesh=None, **kw)
    cfg = config.get_config("tiny", **over)
    params = params_from_jax(jax.tree.map(np.array, jtr.state.params), cfg.model)
    opt = adam_state_from_jax(jax.tree.map(np.array, jtr.state.opt_state), cfg.model)
    jtr.train(max_steps=4)
    tr = Trainer(cfg, work_dir=str(tmp / "p"), device="cpu", **kw)
    tr.state = create_train_state(cfg, device="cpu", params=params, opt=opt)
    tr.train(max_steps=4)
    return _records(tmp / "j"), _records(tmp / "p")


def test_trainer_matches_jax(parity):
    jrec, prec = parity
    assert len(prec) == len(jrec) == 7
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    for j, p in zip(jrec, prec):
        assert sorted(p) == sorted(j)
        assert p["step"] == j["step"]
        if "loss" in j:
            assert rel(p["loss"], j["loss"]) <= 1e-5, (p, j)
            assert rel(p["grad_norm"], j["grad_norm"]) <= 1e-5, (p, j)
            assert abs(p["accuracy"] - j["accuracy"]) <= 1e-6
            assert rel(p["lr"], j["lr"]) <= 1e-6
            assert p["epoch"] == j["epoch"]
        else:
            assert rel(p["dev_loss"], j["dev_loss"]) <= 1e-5, (p, j)
            assert p["dev_tokens"] == j["dev_tokens"]
            assert p["dev_cer"] == j["dev_cer"]


def _cfg(**over):
    return config.get_config("tiny", **dict(SMALL, **over))


def test_checkpoint_round_trip_exact(tmp_path):
    cfg = _cfg(**{"train.moment_dtype": "bfloat16"})
    state = create_train_state(cfg, device="cpu", seed=3)
    g = torch.Generator().manual_seed(0)
    for k in state.opt.mu:
        state.opt.mu[k].copy_(torch.randn(state.opt.mu[k].shape, generator=g))
        state.opt.nu[k].copy_(torch.rand(state.opt.nu[k].shape, generator=g))
    state.opt.count.fill_(7)
    ck = Checkpointer(str(tmp_path / "ck"))
    assert ck.save(9, CheckpointState.of(state, 3, 11, "h", best_dev_loss=0.5,
                                         best_dev_step=4))
    assert not ck.save(9, CheckpointState.of(state, 0, 0, "x"))   # not rewritten
    step, r = Checkpointer(str(tmp_path / "ck")).restore()
    assert step == 9 and (r.epoch, r.batch_in_epoch) == (3, 11)
    assert (r.config_hash, r.best_dev_loss, r.best_dev_step, r.num_devices) == (
        "h", 0.5, 4, 1)
    assert r.opt.count.dtype == torch.int32 and int(r.opt.count) == 7
    for k, p in state.model.state_dict().items():
        assert r.params[k].dtype == torch.float32 and torch.equal(r.params[k], p)
    for k in state.opt.mu:
        assert r.opt.mu[k].dtype == r.opt.nu[k].dtype == torch.bfloat16
        assert torch.equal(r.opt.mu[k], state.opt.mu[k])
        assert torch.equal(r.opt.nu[k], state.opt.nu[k])


def test_checkpoint_retention_and_missing(tmp_path):
    state = create_train_state(_cfg(), device="cpu")
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    for s in (1, 2, 3):
        ck.save(s, CheckpointState.of(state, 0, s, "h"))
    assert ck.latest_step() == 3 and ck.all_steps() == [2, 3]
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore()


def test_resume_rejects_other_model(corpus, tmp_path):
    cfg = _cfg(**{"train.batch_size": 4, "train.checkpoint_every_steps": 1})
    Trainer(cfg, work_dir=str(tmp_path), train_manifest=corpus["train"],
            device="cpu").train(max_steps=1)
    other = cfg.replace(model=cfg.model.replace(d_ff=32))
    with pytest.raises(ValueError, match="config hash"):
        Trainer(other, work_dir=str(tmp_path), train_manifest=corpus["train"],
                resume=True, device="cpu")


def test_resume_is_bit_exact_with_dropout(corpus, tmp_path):
    cfg = _cfg(**{"model.dropout_rate": 0.1, "train.batch_size": 4,
                  "train.checkpoint_every_steps": 100, "train.log_every": 2})
    kw = dict(train_manifest=corpus["train"], device="cpu")
    straight = Trainer(cfg, work_dir=str(tmp_path / "a"), **kw).train(max_steps=6)
    Trainer(cfg, work_dir=str(tmp_path / "b"), **kw).train(max_steps=3)
    resumed = Trainer(cfg, work_dir=str(tmp_path / "b"), resume=True, **kw)
    assert (resumed.state.step, resumed.start_epoch, resumed.start_batch) == (3, 1, 1)
    resumed = resumed.train(max_steps=6)
    assert resumed.step == straight.step == 6
    assert int(resumed.opt.count) == int(straight.opt.count) == 6
    for k, p in straight.params.items():
        assert torch.equal(resumed.params[k], p), k
        for m in ("mu", "nu"):
            a, b = getattr(resumed.opt, m)[k], getattr(straight.opt, m)[k]
            assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b), (m, k)


def test_resume_is_bit_exact_with_spec_augment_and_master_weights(corpus, tmp_path):
    """SpecAugment masks and dropout bits are functions of (seed, step) and
    the checkpoint carries the f32 master: a run stopped mid-epoch resumes
    bit for bit."""
    cfg = _cfg(**{"model.dropout_rate": 0.1, "model.dtype": "bfloat16",
                  "spec_augment.enabled": True, "train.fused_optimizer": True,
                  "train.master_weights": True, "train.batch_size": 4,
                  "train.checkpoint_every_steps": 100, "train.log_every": 2})
    kw = dict(train_manifest=corpus["train"], device="cpu")
    straight = Trainer(cfg, work_dir=str(tmp_path / "a"), **kw).train(max_steps=6)
    Trainer(cfg, work_dir=str(tmp_path / "b"), **kw).train(max_steps=3)
    resumed = Trainer(cfg, work_dir=str(tmp_path / "b"), resume=True, **kw)
    assert (resumed.state.step, resumed.start_epoch, resumed.start_batch) == (3, 1, 1)
    assert resumed.state.opt.master is not None
    resumed = resumed.train(max_steps=6)
    assert resumed.step == straight.step == 6
    for k, p in straight.params.items():
        assert p.dtype == torch.bfloat16 and torch.equal(resumed.params[k], p), k
        for m in ("mu", "nu", "master"):
            a, b = getattr(resumed.opt, m)[k], getattr(straight.opt, m)[k]
            assert torch.equal(a, b), (m, k)
    unaugmented = Trainer(cfg.replace(spec_augment=cfg.spec_augment.replace(enabled=False)),
                          work_dir=str(tmp_path / "c"), **kw).train(max_steps=6)
    assert not torch.equal(unaugmented.opt.master["encoder.subsample.conv0.weight"],
                           straight.opt.master["encoder.subsample.conv0.weight"])


@pytest.mark.parametrize("preset", ["large", "librispeech"])
def test_large_and_librispeech_presets_train(preset, corpus, tmp_path):
    """The two presets that need SpecAugment (and, for ``large``, remat and
    the scanned layout), cut to 1+1 layers and a narrow width, take two
    steps through the ``Trainer`` with dev evaluation; ``large`` once more
    with master weights, served from ``work_dir/best``."""
    from speech_tranformer_pytorch_tpu_torch.recognize import load_recognizer

    over = dict(SMALL, **{"model.dropout_rate": 0.1, "data.bpe_vocab_size": 32,
                          "train.batch_size": 4, "train.eval_every_steps": 2,
                          "train.checkpoint_every_steps": 100, "train.log_every": 1,
                          "train.dev_decode_batches": 1, "decode.max_decode_len": 4})
    variants = [over]
    if preset == "large":
        variants.append(dict(over, **{"train.fused_optimizer": True,
                                      "train.master_weights": True}))
    for i, o in enumerate(variants):
        cfg = config.get_config(preset, **o)
        assert cfg.spec_augment.enabled and cfg.model.remat == (preset == "large")
        work = str(tmp_path / f"w{i}")
        state = Trainer(cfg, work_dir=work, train_manifest=corpus["train"],
                        dev_manifest=corpus["dev"], device="cpu").train(max_steps=2)
        assert state.step == 2 and all(math.isfinite(r["loss"]) for r in _records(work)
                                       if "loss" in r)
        rec = load_recognizer(cfg, f"{work}/best", device="cpu")
        served = dict(rec.model.named_parameters())
        for k, p in state.params.items():
            assert torch.equal(served[k], p.detach().to(served[k].dtype)), k


def test_best_model_tracking_resume_safe(corpus, tmp_path):
    cfg = _cfg(**{"train.batch_size": 4, "train.num_epochs": 50,
                  "train.log_every": 100, "train.checkpoint_every_steps": 100,
                  "train.eval_every_steps": 0})
    wd = str(tmp_path / "w")
    tr = Trainer(cfg, work_dir=wd, train_manifest=corpus["train"], device="cpu")
    tr.evaluate = lambda **kw: {"loss": 1.0, "tokens": 10.0}
    tr._dev_eval(0, 0)
    assert tr.best_dev_loss == 1.0
    tr.train(max_steps=2)

    tr2 = Trainer(cfg, work_dir=wd, train_manifest=corpus["train"], resume=True,
                  device="cpu")
    assert (tr2.best_dev_loss, tr2.best_dev_step) == (1.0, 0)
    tr2.evaluate = lambda **kw: {"loss": 2.0, "tokens": 10.0}
    tr2._dev_eval(0, 0)
    assert tr2.best_dev_loss == 1.0
    assert Checkpointer(f"{wd}/best").latest_step() == 0
    tr2.evaluate = lambda **kw: {"loss": 0.5, "tokens": 10.0}
    tr2._dev_eval(0, 0)
    assert tr2.best_dev_loss == 0.5
    assert Checkpointer(f"{wd}/best").all_steps() == [2]


def test_hot_loop_reads_metrics_once_a_log(corpus, tmp_path, monkeypatch):
    cfg = _cfg(**{"train.batch_size": 2, "train.num_epochs": 100, "train.log_every": 4,
                  "train.checkpoint_every_steps": 1000, "train.eval_every_steps": 0})
    tr = Trainer(cfg, work_dir=str(tmp_path / "w"), train_manifest=corpus["train"],
                 device="cpu")
    calls = []
    for name in ("item", "tolist", "cpu", "numpy", "__float__", "__int__", "__bool__"):
        orig = getattr(torch.Tensor, name)

        def counting(self, *a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counting)
    tr.train(max_steps=8)
    monkeypatch.undo()
    # One batched read at each of the two log boundaries; a per-step read
    # would make 8 or more.
    assert calls == ["tolist", "tolist"], calls
    assert len(_records(tmp_path / "w")) == 2


def _cli_common(data):
    return (["--preset", "tiny", "--data-dir", str(data), "--device", "cpu"] + CLI_SMALL
            + ["--set", "train.batch_size=8", "--set", "train.checkpoint_every_steps=2",
               "--set", "train.eval_every_steps=2", "--set", "train.log_every=2"])


def _recognize(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        recognize_cli.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_flow(tmp_path):
    data, work = tmp_path / "d", tmp_path / "w"
    prepare_cli.main(["synthetic", "--device", "cpu", "--out", str(data),
                      "--num-train", "8", "--num-dev", "4", "--num-test", "4",
                      "--vocab-size", "16"])
    common = _cli_common(data) + ["--work-dir", str(work)]
    train_cli.main(common + ["--set", "train.moment_dtype=float32", "--max-steps", "2"])
    train_cli.main(common + ["--resume", "--max-steps", "4"])
    saved = config.config_from_dict(json.load(open(work / "config.json")))
    assert saved.train.moment_dtype == "float32"       # the saved config won
    assert Checkpointer(str(work / "checkpoints")).latest_step() == 4
    assert (work / "best").is_dir()
    for ckpt in ("latest", "best"):
        scores = _recognize(["--data-dir", str(data), "--work-dir", str(work),
                             "--split", "test", "--beam", "2", "--batch-size", "3",
                             "--checkpoint", ckpt, "--device", "cpu",
                             "--out", str(tmp_path / f"{ckpt}.jsonl")])
        assert scores["utterances"] == 4.0
        assert {"cer", "rtf", "rtf_with_compile", "audio_seconds"} <= set(scores)
        assert math.isfinite(scores["cer"]) and scores["rtf"] > 0
        assert len(open(tmp_path / f"{ckpt}.jsonl").readlines()) == 4


def test_cli_refusals(tmp_path):
    data, work = tmp_path / "d", tmp_path / "w"
    prepare_cli.main(["synthetic", "--device", "cpu", "--out", str(data),
                      "--num-train", "4", "--num-dev", "0", "--num-test", "0",
                      "--vocab-size", "16"])
    common = _cli_common(data) + ["--work-dir", str(work)]
    train_cli.main(common + ["--max-steps", "1"])
    with pytest.raises(FileNotFoundError, match="best"):
        recognize_cli.main(["--data-dir", str(data), "--work-dir", str(work),
                            "--split", "train", "--checkpoint", "best",
                            "--device", "cpu"])
    # A model axis that does not divide the ranks is refused, and the
    # one-rank process group the CLI started is released.
    rec = ["--data-dir", str(data), "--work-dir", str(work)]
    bad = ["--set", "mesh.model_axis=2", "--device", "cpu"]
    for cli, args in ((train_cli, common + ["--mesh", "on"]),
                      (recognize_cli, rec + ["--mesh", "on"]),
                      (recognize_cli, rec + ["--distributed"])):
        with pytest.raises(ValueError, match="must divide"):
            cli.main(args + bad)
        assert not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            prepare_cli.main(["synthetic", "--out", str(tmp_path / "d2")])
        no_device = [a for a in common if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="CUDA"):
            train_cli.main(no_device + ["--max-steps", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            recognize_cli.main(["--data-dir", str(data), "--work-dir", str(work),
                                "--split", "train"])


@pytest.mark.parametrize("preset", sorted(config.PRESETS))
def test_config_hashes_match_jax(preset):
    cfg, jcfg = config.get_config(preset), jconfig.get_config(preset)
    assert cfg.model_hash() == jcfg.model_hash()
    assert cfg.config_hash() == jcfg.config_hash()
    assert config.config_from_dict(cfg.to_dict()) == cfg
    assert config.config_from_dict(json.loads(jcfg.to_json())) == cfg
