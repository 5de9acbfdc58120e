"""Port ``Recognizer.decode_manifest`` against the JAX package's.

The port's ``Trainer`` trains a small tiny-preset model (d_model 128, 1+1
layers, dropout 0) on an 8-utterance synthetic train split until it
decodes it (100 steps, on two CPU threads: the suite's workers share the
machine's cores); both packages then serve the same weights
(``convert.params_to_jax`` for the JAX side) over that manifest in batches
of 3, so the last batch carries a padding row. At beam 5, greedily, with
``decode.max_len_ratio`` and with int8 weights and the int8 cross-K/V
cache (the JAX side at ``ST_TPU_INT8_MIN_WEIGHT_BYTES=0``, its kernel
math), the hypotheses, ``cer``, ``errors``, ``ref_tokens``,
``utterances`` and ``audio_seconds`` are identical, and so are the
``out_path`` files. A BPE manifest gives the same ``wer``, and
``load_recognizer`` from the port checkpoint decodes as the weights it
saved."""

import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import get_config as jax_get_config  # noqa: E402
from speech_tranformer_pytorch_tpu.data.tokenizer import (  # noqa: E402
    BpeTokenizer as JaxBpe, load_tokenizer as jax_load_tokenizer)
from speech_tranformer_pytorch_tpu.recognize import Recognizer as JaxRecognizer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import params_to_jax  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.prepare import (  # noqa: E402
    prepare_synthetic, read_manifest, write_manifest)
from speech_tranformer_pytorch_tpu_torch.data.tokenizer import (  # noqa: E402
    BpeTokenizer, load_tokenizer)
from speech_tranformer_pytorch_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.recognize import (  # noqa: E402
    Recognizer, load_recognizer)
from speech_tranformer_pytorch_tpu_torch.runner import Trainer  # noqa: E402

MODEL = {"model.vocab_size": 32, "model.d_model": 128, "model.num_heads": 2,
         "model.d_ff": 256, "model.num_encoder_layers": 1, "model.num_decoder_layers": 1,
         "model.dropout_rate": 0.0, "model.subsample_channels": 8}
TRAIN = {"train.batch_size": 8, "train.num_epochs": 400, "train.warmup_steps": 50,
         "train.log_every": 1000, "train.checkpoint_every_steps": 10_000}
INT8 = {"decode.int8_weights": True, "decode.int8_kv_cache": True}
CASES = {"beam5": ({}, dict(beam_size=5, max_len=8)),
         "greedy": ({}, dict(beam_size=1, max_len=8)),
         "max_len_ratio": ({"decode.max_len_ratio": 0.3, "decode.max_decode_len": 32},
                           dict(beam_size=5)),
         "int8_beam5": (INT8, dict(beam_size=5, max_len=8)),
         "int8_greedy": (INT8, dict(beam_size=1, max_len=8))}
EXACT = ("cer", "errors", "ref_tokens", "utterances", "audio_seconds")


@pytest.fixture(scope="module")
def kernel_math():
    """The JAX int8 denses take their kernel math at every size."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ST_TPU_INT8_MIN_WEIGHT_BYTES", "0")
        yield


@pytest.fixture(scope="module")
def trained(tmp_path_factory, kernel_math):
    tmp = tmp_path_factory.mktemp("recman")
    paths = prepare_synthetic(str(tmp / "c"), num_train=8, num_dev=0, num_test=0,
                              vocab_size=16, seed=2)
    cfg = get_config("tiny", **MODEL, **TRAIN)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        tr = Trainer(cfg, work_dir=str(tmp / "w"), train_manifest=paths["train"],
                     device="cpu")
        tr.train(max_steps=100)
        params = {k: v.detach().clone() for k, v in tr.state.model.state_dict().items()}
        yield tmp, paths, params
    finally:
        torch.set_num_threads(threads)


def _decode_both(trained, over, kw, name, tokenizers=None, manifest=None):
    tmp, paths, params = trained
    manifest = manifest or paths["train"]
    cfg = get_config("tiny", **MODEL, **over)
    jcfg = jax_get_config("tiny", **MODEL, **over)
    ptok, jtok = tokenizers or (load_tokenizer(paths["vocab"]),
                                jax_load_tokenizer(paths["vocab"]))
    rec = Recognizer(cfg, params, tokenizer=ptok, device="cpu")
    jrec = JaxRecognizer(jcfg, params_to_jax(params, cfg.model), tokenizer=jtok)
    pout, jout = str(tmp / f"{name}_p.jsonl"), str(tmp / f"{name}_j.jsonl")
    got = rec.decode_manifest(manifest, batch_size=3, out_path=pout, **kw)
    want = jrec.decode_manifest(manifest, batch_size=3, out_path=jout, **kw)
    return got, want, open(pout, "rb").read(), open(jout, "rb").read()


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_manifest_matches_jax(trained, case):
    got, want, pfile, jfile = _decode_both(trained, *CASES[case], case)
    assert set(got) == set(want)
    assert {k: got[k] for k in EXACT} == {k: want[k] for k in EXACT}
    assert got["utterances"] == 8.0 and got["rtf"] > 0 and got["rtf_with_compile"] > 0
    assert pfile == jfile
    if not case.startswith("int8"):
        assert got["cer"] == 0.0      # the model decodes its train split


def test_max_len_ratio_caps_the_decode(trained):
    """0.2 of the bucket's 24 encoder frames leaves 4 decode steps, fewer
    than the longest transcripts need: hypotheses stop at 4 tokens and the
    CER rises. (The parity case's 0.3 leaves 7 steps, enough for 6 tokens
    and <eos>.)"""
    got, _, pfile, _ = _decode_both(trained, {"decode.max_len_ratio": 0.2,
                                              "decode.max_decode_len": 32},
                                    dict(beam_size=5), "cap")
    lens = [len(json.loads(line)["tokens"]) for line in pfile.decode().splitlines()]
    assert max(lens) <= 4 and got["cer"] > 0.0


def test_wer_matches_jax_on_bpe_manifest(trained):
    tmp, paths, _ = trained
    words = ["ALPHA", "BRAVO", "CHARLIE", "DELTA", "ECHO", "FOXTROT", "GOLF", "HOTEL",
             "INDIA", "JULIET", "KILO", "LIMA"]
    entries = read_manifest(paths["train"])
    for e in entries:
        e["text"] = " ".join(words[(ord(c) - 0x4E00) % len(words)] for c in e["text"])
    bpe = BpeTokenizer.train([e["text"] for e in entries], 30)
    jbpe = JaxBpe.train([e["text"] for e in entries], 30)
    assert bpe.vocab == jbpe.vocab and bpe.vocab_size <= 32
    for e in entries:
        e["tokens"] = bpe.encode(e["text"])[:20]
    manifest = str(tmp / "bpe.jsonl")
    write_manifest(manifest, entries)
    got, want, pfile, jfile = _decode_both(trained, {}, dict(beam_size=5, max_len=8),
                                           "bpe", (bpe, jbpe), manifest)
    assert "wer" in got and got["wer"] == want["wer"]
    assert {k: got[k] for k in EXACT} == {k: want[k] for k in EXACT}
    assert pfile == jfile


def test_load_recognizer_from_port_checkpoint(trained):
    tmp, paths, params = trained
    cfg = get_config("tiny", **MODEL)
    rec = load_recognizer(cfg, str(tmp / "w" / "checkpoints"), vocab_path=paths["vocab"],
                          device="cpu")
    assert rec.tokenizer is not None
    for k, v in rec.model.state_dict().items():
        assert torch.equal(v, params[k]), k
    scores = rec.decode_manifest(paths["train"], beam_size=5, max_len=8, batch_size=3)
    assert scores["cer"] == 0.0 and scores["utterances"] == 8.0


def test_mesh_and_distributed_are_refused(trained):
    """What the mesh path refuses, as JAX's does: int8 serving with a mesh,
    and a distributed decode without one."""
    _, paths, params = trained
    cfg = get_config("tiny", **MODEL)
    mesh = Mesh(1, 1, 0, torch.device("cpu"), None, None, [0])
    for flag in ("int8_weights", "int8_kv_cache"):
        int8 = cfg.replace(decode=cfg.decode.replace(**{flag: True}))
        with pytest.raises(ValueError, match="single-device"):
            Recognizer(int8, params, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="needs a mesh"):
        Recognizer(cfg, params, device="cpu").decode_manifest(paths["train"],
                                                              distributed=True)
