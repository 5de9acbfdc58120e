"""A JAX ``Trainer`` checkpoint in the port: ``convert_jax_checkpoint.py``
(the one file that imports JAX to convert) writes an ``.npz``,
``convert.checkpoint_from_npz`` and ``utils/checkpoint.write_checkpoint``
make a port work dir of it.

Two tiny JAX runs (dropout 0, 4 steps of two-batch epochs, a checkpoint
every step, config.json beside them) cover both of JAX's optimizer
states: the optax chain (``train.fused_optimizer=False``, the default;
float32 moments, unscanned layers) and ``FusedAdam`` (scanned encoder
layers, bfloat16 moments). For each:

- the ``.npz`` holds every tree, the Adam count, step, epoch, batch and
  best-dev fields, the config hash and the config, and the port state it
  makes equals the JAX state exactly (params and moments in their own
  dtypes); a config asking for ``FusedAdam`` over the optax chain's
  checkpoint (a JAX mesh run's layout) converts to the same file;
- ``load_recognizer`` on the port work dir decodes token-equal to the JAX
  ``load_recognizer`` on the same checkpoint (beam 3);
- the port ``Trainer`` resumed from step 3 takes step 4 as JAX's run took
  it: the loss and grad norm within 1e-5 relative and accuracy and lr
  within 1e-6 (the tolerances of ``tests/test_torch_runner.py``'s trainer
  parity), and every parameter after the step within 1e-5 of its leaf's
  largest value (f32 summation order; measured up to 2.2e-6), except the
  attention key biases: their exact gradient is zero, so Adam turns the
  rounding noise each package computes into a step of up to lr either
  way, and they are held within 2·lr (measured 0.30·lr; ROADMAP section C).

The JAX ``Trainer`` records batch 0 of its epoch when ``max_steps`` stops
it (JAX ``runner.py:306``), the port the next batch (ROADMAP section C), so
the step-3 checkpoint used here is the one its every-step save wrote,
which records the next batch in both packages."""

import json
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import convert_jax_checkpoint  # noqa: E402
from speech_tranformer_pytorch_tpu import config as jconfig  # noqa: E402
from speech_tranformer_pytorch_tpu import train as jtrain  # noqa: E402
from speech_tranformer_pytorch_tpu.recognize import (  # noqa: E402
    load_recognizer as jax_load_recognizer)
from speech_tranformer_pytorch_tpu.runner import Trainer as JaxTrainer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch import config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import (  # noqa: E402
    _find_moments, checkpoint_from_npz, params_from_jax)
from speech_tranformer_pytorch_tpu_torch.data.pipeline import BucketedBatcher, ManifestDataset  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.prepare import prepare_synthetic  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.recognize import load_recognizer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.runner import Trainer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.utils.checkpoint import write_checkpoint  # noqa: E402

SMALL = {"model.vocab_size": 32, "model.d_model": 32, "model.num_heads": 2,
         "model.d_ff": 64, "model.num_encoder_layers": 2,
         "model.num_decoder_layers": 1, "model.dropout_rate": 0.0,
         "model.subsample_channels": 4, "train.batch_size": 4, "train.log_every": 1,
         "train.checkpoint_every_steps": 1, "train.keep_checkpoints": 5}
LAYOUTS = {
    "optax": {"train.fused_optimizer": False, "train.moment_dtype": "float32"},
    "fused_scanned": {"train.fused_optimizer": True, "model.scan_layers": True,
                      "train.moment_dtype": "bfloat16"},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return prepare_synthetic(str(tmp_path_factory.mktemp("jaxckpt") / "c"),
                             num_train=8, num_dev=0, num_test=0, vocab_size=16, seed=4)


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def run(request, corpus, tmp_path_factory):
    """The JAX run, its step-3 and step-4 checkpoints converted, and port
    work dirs made of both. The JAX init runs as one jit and TensorFlow is
    hidden from its logger, as in ``tests/test_torch_runner.py``."""
    over = dict(SMALL, **LAYOUTS[request.param])
    jcfg, cfg = jconfig.get_config("tiny", **over), config.get_config("tiny", **over)
    tmp = tmp_path_factory.mktemp(request.param)
    jdir = tmp / "jax"
    jdir.mkdir()
    (jdir / "config.json").write_text(jcfg.to_json())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "init_params", jax.jit(jtrain.init_params, static_argnums=0))
        mp.setitem(sys.modules, "tensorflow", None)
        jtr = JaxTrainer(jcfg, work_dir=str(jdir), train_manifest=corpus["train"],
                         mesh=None)
    jtr.train(max_steps=4)
    jtr.ckpt.wait()
    out = {"cfg": cfg, "jcfg": jcfg, "jdir": jdir, "jstate": jtr.state}
    for step in (3, 4):
        npz = str(tmp / f"step{step}.npz")
        convert_jax_checkpoint.main(["--work-dir", str(jdir), "--out", npz,
                                     "--step", str(step)])
        out[f"npz{step}"] = npz
        port_dir = tmp / f"port{step}"
        s, ckpt = checkpoint_from_npz(npz, cfg)
        assert s == step
        write_checkpoint(str(port_dir), s, ckpt, cfg)
        out[f"port{step}"] = port_dir
    with open(jdir / "train_metrics.jsonl") as f:
        out["jrecords"] = [json.loads(line) for line in f]
    return out


def test_npz_carries_the_whole_state(run):
    cfg = run["cfg"]
    with np.load(run["npz4"]) as z:
        files = set(z.files)
        assert int(z["step"]) == 4 and int(z["count"]) == 4
        assert (int(z["epoch"]), int(z["batch_in_epoch"])) == (1, 2)   # the every-step save
        assert float(z["best_dev_loss"]) == np.inf and int(z["best_dev_step"]) == -1
        assert str(z["config_hash"]) == cfg.model_hash()
        assert config.config_from_dict(json.loads(str(z["config_json"]))) == cfg
        assert str(z["dtype/mu"]) == cfg.train.moment_dtype
        assert str(z["dtype/params"]) == "float32"
    for group in ("params", "mu", "nu"):
        assert any(f.startswith(group + "/") for f in files), group
    assert not any(f.startswith("master/") for f in files)
    scanned = any("/layers/layer/" in f for f in files)
    assert scanned == cfg.model.scan_layers
    step, ckpt = checkpoint_from_npz(run["npz4"], cfg)
    jstate = jax.tree.map(np.asarray, run["jstate"])
    node = _find_moments(jstate.opt_state)
    assert int(ckpt.opt.count) == int(node.count) == 4
    for tree, mine in ((jstate.params, ckpt.params), (node.mu, ckpt.opt.mu),
                       (node.nu, ckpt.opt.nu)):
        want = params_from_jax(tree, cfg.model)
        assert sorted(want) == sorted(mine)
        for k, v in want.items():
            assert mine[k].dtype == v.dtype and torch.equal(mine[k], v), k
    if not cfg.train.fused_optimizer:
        # A config that asks for FusedAdam over a checkpoint in the optax
        # chain's layout (as every JAX mesh run writes): the converter
        # falls back to that layout and gives the same file.
        other = run["jdir"].parent / "fused_config.json"
        other.write_text(run["jcfg"].replace(train=run["jcfg"].train.replace(
            fused_optimizer=True)).to_json())
        again = str(run["jdir"].parent / "again.npz")
        convert_jax_checkpoint.main(["--work-dir", str(run["jdir"]), "--out", again,
                                     "--config", str(other)])
        with np.load(run["npz4"]) as a, np.load(again) as b:
            assert sorted(a.files) == sorted(b.files)
            for f in a.files:
                if f != "config_json":
                    np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert (run["port4"] / "config.json").exists()
    assert (run["port4"] / "checkpoints" / "config_hash.txt").read_text().strip() == \
        cfg.model_hash()


def test_port_serves_the_jax_checkpoint(run, corpus, monkeypatch):
    cfg, jcfg = run["cfg"], run["jcfg"]
    # The JAX template's init as one jit, as in the fixture.
    monkeypatch.setattr(jtrain, "init_params", jax.jit(jtrain.init_params, static_argnums=0))
    ds = ManifestDataset(corpus["train"], cfg.data, cfg.features)
    batch = next(BucketedBatcher(ds, batch_size=3, bucket_boundaries=cfg.data.bucket_boundaries,
                                 target_len=16, shuffle=False).epoch(0))
    ours = load_recognizer(cfg, str(run["port4"] / "checkpoints"), device="cpu")
    theirs = jax_load_recognizer(jcfg, str(run["jdir"] / "checkpoints"))
    from speech_tranformer_pytorch_tpu.data.pipeline import AudioBatch as JaxAudioBatch
    jbatch = JaxAudioBatch(*(jax.numpy.asarray(getattr(batch, f).numpy()) for f in
                             ("audio", "sample_lens", "targets_in", "targets_out",
                              "target_lens", "valid")))
    got = ours.decode_batch(batch.audio, batch.sample_lens, beam_size=3, max_len=6,
                            alpha=0.0)
    assert got == theirs.decode_batch(jbatch, beam_size=3, max_len=6, alpha=0.0)
    assert any(got)


def test_resumed_port_step_matches_jax(run, corpus):
    cfg = run["cfg"]
    tr = Trainer(cfg, work_dir=str(run["port3"]), train_manifest=corpus["train"],
                 resume=True, device="cpu")
    assert (tr.state.step, tr.start_epoch, tr.start_batch) == (3, 1, 1)
    state = tr.train(max_steps=4)
    with open(run["port3"] / "train_metrics.jsonl") as f:
        mine = [json.loads(line) for line in f]
    want = [r for r in run["jrecords"] if r["step"] == 4 and "loss" in r]
    assert [r["step"] for r in mine] == [4] and len(want) == 1
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    (p,), (j,) = mine, want
    assert rel(p["loss"], j["loss"]) <= 1e-5, (p, j)
    assert rel(p["grad_norm"], j["grad_norm"]) <= 1e-5, (p, j)
    assert abs(p["accuracy"] - j["accuracy"]) <= 1e-6
    assert rel(p["lr"], j["lr"]) <= 1e-6
    jparams = params_from_jax(jax.tree.map(np.asarray, run["jstate"].params), cfg.model)
    d, lr = cfg.model.d_model, p["lr"]
    for k, v in jparams.items():
        diff = (state.params[k].detach() - v).abs()
        key_bias = torch.zeros_like(diff, dtype=torch.bool)
        if k.endswith("cross_attn.k.bias"):
            key_bias[:] = True
        elif k.endswith("self_attn.qkv.bias"):
            key_bias[d:2 * d] = True
        assert float(torch.where(key_bias, 0.0, diff).max()) <= 1e-5 * float(v.abs().max()), k
        assert float(torch.where(key_bias, diff, 0.0).max()) <= 2 * lr, k
