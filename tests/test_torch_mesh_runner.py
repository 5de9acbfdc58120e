"""The port's ``Trainer(mesh=...)``, mesh checkpoints,
``decode_manifest(distributed=True)`` and the CLIs' ``--mesh on`` /
``--distributed`` on gloo ranks of the CPU.

- ``Trainer`` on a (2, 1) mesh of 2 ranks (``parallel.mesh.spawn_ranks``;
  the ranks import nothing of JAX) for 3 steps with dev evaluations
  against the single-rank ``Trainer`` on the same global batches: each
  logged loss and grad norm within 1e-5 relative, accuracy and lr at
  1e-6, dev loss at 1e-5, dev tokens and greedy dev CER exactly, the same
  record keys; rank 0 alone writes the log.
- A mesh run stopped at step 2 and resumed on the same mesh is
  bit-identical to the straight run; its checkpoint (one whole tree,
  written by rank 0) serves through ``load_recognizer`` with no mesh.
- ``decode_manifest(distributed=True)`` returns the same scores on every
  rank as the single-rank call (the timing keys aside), and only rank 0
  writes ``out_path``.
- ``train_cli`` and ``recognize_cli`` with ``--mesh on`` (and
  ``--distributed``) under a 2-rank launch with ``torchrun``'s environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``),
  tensor-parallel over both ranks: both exit 0 and print the same scores.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.prepare import prepare_synthetic  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, spawn_ranks)
from speech_tranformer_pytorch_tpu_torch.recognize import load_recognizer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.runner import Trainer  # noqa: E402

SMALL = {"model.vocab_size": 16, "model.d_model": 32, "model.num_heads": 2,
         "model.d_ff": 64, "model.num_encoder_layers": 1, "model.num_decoder_layers": 1,
         "model.dropout_rate": 0.0, "model.subsample_channels": 4,
         "train.batch_size": 4, "train.log_every": 1, "train.eval_every_steps": 2,
         "train.checkpoint_every_steps": 100, "train.moment_dtype": "float32"}
TIMING = ("rtf", "rtf_with_compile")


def _cfg():
    return get_config("tiny", **SMALL)


def _records(work):
    with open(os.path.join(work, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _mesh_rank(rank, corpus, root):
    torch.set_num_threads(1)
    cfg = _cfg()
    mesh = make_mesh(cfg.mesh, device="cpu")
    kw = dict(train_manifest=corpus["train"], dev_manifest=corpus["dev"], mesh=mesh,
              device="cpu")
    Trainer(cfg, work_dir=f"{root}/straight", **kw).train(max_steps=3)
    Trainer(cfg, work_dir=f"{root}/resumed", **kw).train(max_steps=2)
    Trainer(cfg, work_dir=f"{root}/resumed", resume=True, **kw).train(max_steps=3)
    rec = load_recognizer(cfg, f"{root}/straight/checkpoints", mesh=mesh, device="cpu")
    scores = rec.decode_manifest(corpus["train"], beam_size=3, max_len=6, batch_size=3,
                                 distributed=True, out_path=f"{root}/hyps{rank}.jsonl")
    return scores


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return prepare_synthetic(str(tmp_path_factory.mktemp("mesh_runner") / "c"),
                             num_train=8, num_dev=4, num_test=0, vocab_size=16, seed=0)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_runs"))
    scores = spawn_ranks(_mesh_rank, 2, corpus, root)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        single = Trainer(_cfg(), work_dir=f"{root}/single", train_manifest=corpus["train"],
                         dev_manifest=corpus["dev"], mesh=None, device="cpu")
        single.train(max_steps=3)
    finally:
        torch.set_num_threads(threads)
    return root, scores


def test_mesh_trainer_matches_single_rank(runs):
    root, _ = runs
    mesh, single = _records(f"{root}/straight"), _records(f"{root}/single")
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    assert len(mesh) == len(single) > 3
    for p, s in zip(mesh, single):
        assert sorted(p) == sorted(s) and p["step"] == s["step"]
        if "loss" in s:
            assert rel(p["loss"], s["loss"]) <= 1e-5, (p, s)
            assert rel(p["grad_norm"], s["grad_norm"]) <= 1e-5, (p, s)
            assert abs(p["accuracy"] - s["accuracy"]) <= 1e-6
            assert rel(p["lr"], s["lr"]) <= 1e-6
        else:
            assert rel(p["dev_loss"], s["dev_loss"]) <= 1e-5, (p, s)
            assert p["dev_tokens"] == s["dev_tokens"] and p["dev_cer"] == s["dev_cer"]


def test_mesh_resume_is_bit_exact(runs):
    root, _ = runs
    a = torch.load(f"{root}/straight/checkpoints/step_3.pt", weights_only=True)
    b = torch.load(f"{root}/resumed/checkpoints/step_3.pt", weights_only=True)
    for part in ("params", "mu", "nu"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    assert a["meta"]["num_devices"] == 2


def test_mesh_checkpoint_and_distributed_decode_match_single_rank(runs, corpus):
    root, scores = runs
    rec = load_recognizer(_cfg(), f"{root}/straight/checkpoints", device="cpu")
    want = rec.decode_manifest(corpus["train"], beam_size=3, max_len=6, batch_size=6)
    for got in scores:
        assert {k: v for k, v in got.items() if k not in TIMING} == {
            k: v for k, v in want.items() if k not in TIMING}
    assert os.path.exists(f"{root}/hyps0.jsonl") and not os.path.exists(f"{root}/hyps1.jsonl")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(module, args, world=2):
    """``module`` as ``torchrun --nproc-per-node world`` would start it."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-m", module] + args, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [out for out, _ in outs]


def test_clis_under_a_two_rank_launch(corpus, tmp_path):
    pkg = "speech_tranformer_pytorch_tpu_torch"
    data = os.path.dirname(corpus["train"])
    work = str(tmp_path / "w")
    sets = [a for k, v in SMALL.items() if k != "model.vocab_size"
            for a in ("--set", f"{k}={v}")] + ["--set", "mesh.model_axis=2"]
    common = ["--preset", "tiny", "--data-dir", data, "--device", "cpu"]
    outs = _launch(f"{pkg}.train_cli", common + sets + ["--work-dir", work, "--mesh", "on",
                                                        "--max-steps", "2"])
    assert "done: step=2" in outs[0]
    assert os.path.exists(os.path.join(work, "checkpoints", "step_2.pt"))
    outs = _launch(f"{pkg}.recognize_cli", ["--data-dir", data, "--work-dir", work,
                                            "--split", "train", "--device", "cpu",
                                            "--beam", "2", "--max-len", "4",
                                            "--mesh", "on", "--distributed"])
    scores = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert scores[0]["utterances"] == 8.0
    assert {k: v for k, v in scores[0].items() if k not in TIMING} == {
        k: v for k, v in scores[1].items() if k not in TIMING}
