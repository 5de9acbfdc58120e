"""Export for serving (port ``serving.py``, ``export_cli.py``) against the
JAX package, at the tiny shapes of ``tests/test_serving.py``: a port
artifact, taken through bytes and ``load_exported``, decodes as JAX's live
``beam_decode`` / greedy decode does on the same converted weights (tokens
and lengths exact, scores within 1e-4; float32, CPU); the exported programs
call the kernel operators (beam: all four; greedy: the two attention ones); the CLI round-trips a trained run
through its ``.npz``; and a process that only loads an artifact imports
none of the model code."""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from speech_tranformer_pytorch_tpu.decoding import (  # noqa: E402
    beam_decode as jax_beam_decode, greedy_decode_jit)
from speech_tranformer_pytorch_tpu.models import SpeechTransformer as JaxModel  # noqa: E402
from speech_tranformer_pytorch_tpu_torch import (  # noqa: E402
    export_cli, prepare_cli, train_cli)
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import params_from_jax  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.serving import (  # noqa: E402
    export_recognizer, flatten_params, load_exported)

TINY = {"model.vocab_size": 16, "model.d_model": 64, "model.num_heads": 2,
        "model.d_ff": 128, "model.num_encoder_layers": 2, "model.num_decoder_layers": 2,
        "model.dropout_rate": 0.0, "model.subsample_channels": 8}
B, FRAMES, MAX_LEN = 3, 120, 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny_config()
    jcfg = jcfg.replace(model=jcfg.model.replace(
        vocab_size=16, d_model=64, num_heads=2, d_ff=128, num_encoder_layers=2,
        num_decoder_layers=2, dropout_rate=0.0, subsample_channels=8))
    cfg = get_config("tiny", **TINY)
    feats = np.random.default_rng(0).standard_normal(
        (B, FRAMES, cfg.model.input_dim)).astype(np.float32)
    lens = np.array([120, 90, 70], np.int32)
    jmodel = JaxModel(jcfg.model)
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(lens),
        jnp.zeros((B, 4), jnp.int32), jnp.full((B,), 4, jnp.int32)))
    params = params_from_jax(variables, cfg.model)
    return jmodel, variables, cfg, params, feats, lens


@pytest.fixture(scope="module")
def beam_artifact(setup):
    _, _, cfg, params, _, _ = setup
    return export_recognizer(cfg, params, batch_size=B, frames=FRAMES, beam_size=3,
                             max_len=MAX_LEN, device="cpu")


def _call(data, params, feats, lens):
    fn = load_exported(data)
    return fn(flatten_params(params), torch.from_numpy(feats), torch.from_numpy(lens))


def _op_targets(data):
    """Every call_function target of the exported program, its loop's body
    included."""
    ep = torch.export.load(io.BytesIO(data))
    return {str(n.target) for gm in ep.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule)
            for n in gm.graph.nodes if n.op == "call_function"}


def test_export_beam_roundtrip_matches_jax(setup, beam_artifact):
    jmodel, variables, _, params, feats, lens = setup
    assert isinstance(beam_artifact, bytes) and len(beam_artifact) > 0
    tokens, lengths, scores = _call(beam_artifact, params, feats, lens)
    want = jax.jit(lambda p, f, l: jax_beam_decode(
        jmodel, p, f, l, beam_size=3, max_len=MAX_LEN))(
        variables, jnp.asarray(feats), jnp.asarray(lens))
    assert tokens.dtype == lengths.dtype == torch.int32 and scores.dtype == torch.float32
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want.scores), rtol=1e-4,
                               atol=1e-4)
    # The encoder traced to the flash forward op, the loop to the other two.
    ops = _op_targets(beam_artifact)
    for op in ("st_port.flash_fwd", "st_port.lineage_attention",
               "st_port.beam_candidate_topk", "st_port.cross_attention_decode"):
        assert any(t.startswith(op) for t in ops), (op, sorted(ops))


def test_export_greedy_roundtrip_matches_jax(setup):
    jmodel, variables, cfg, params, feats, lens = setup
    data = export_recognizer(cfg, params, batch_size=B, frames=FRAMES, beam_size=1,
                             max_len=MAX_LEN, device="cpu")
    tokens, lengths, scores = _call(data, params, feats, lens)
    want_t, want_l = jax.jit(lambda p, f, l: greedy_decode_jit(
        jmodel, p, f, l, max_len=MAX_LEN))(variables, jnp.asarray(feats), jnp.asarray(lens))
    assert tuple(tokens.shape) == (B, 1, MAX_LEN) and tuple(scores.shape) == (B, 1)
    np.testing.assert_array_equal(tokens[:, 0].numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(lengths[:, 0].numpy(), np.asarray(want_l))
    assert not scores.any()
    ops = _op_targets(data)
    for op in ("st_port.lineage_attention", "st_port.cross_attention_decode"):
        assert any(t.startswith(op) for t in ops), (op, sorted(ops))
    ops = _op_targets(data)
    assert not any(t.startswith("st_port.beam_candidate_topk") for t in ops)


def test_export_under_a_profiler_traces_no_span(setup, beam_artifact):
    """The program's spans (``utils/profiling.named_scope``) are left out
    while exporting, even with a profiler running: the artifact calls the
    same operators and decodes the same."""
    _, _, cfg, params, feats, lens = setup
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        data = export_recognizer(cfg, params, batch_size=B, frames=FRAMES, beam_size=3,
                                 max_len=MAX_LEN, device="cpu")
    ops = _op_targets(data)
    assert not any("profiler" in t or "record_function" in t for t in ops), sorted(ops)
    assert ops == _op_targets(beam_artifact)
    for got, want in zip(_call(data, params, feats, lens),
                         _call(beam_artifact, params, feats, lens)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_load_exported_imports_no_model_code(setup, beam_artifact, tmp_path):
    """A fresh process loads the artifact and decodes with the flat params
    alone: ``models``, ``config`` and ``decoding`` stay unimported."""
    _, _, _, params, feats, lens = setup
    art = tmp_path / "decoder.pt2"
    art.write_bytes(beam_artifact)
    np.savez(tmp_path / "inputs.npz", feats=feats, lens=lens,
             **{f"p{i:05d}": x.numpy() for i, x in enumerate(flatten_params(params))})
    want = _call(beam_artifact, params, feats, lens)[0].numpy()
    np.save(tmp_path / "want.npy", want)
    script = (
        "import sys, numpy as np, torch\n"
        "from speech_tranformer_pytorch_tpu_torch.serving import load_exported\n"
        f"fn = load_exported(open({str(art)!r}, 'rb').read())\n"
        f"z = np.load({str(tmp_path / 'inputs.npz')!r})\n"
        "flat = [torch.from_numpy(z[k]) for k in sorted(z.files) if k.startswith('p')]\n"
        "tokens = fn(flat, torch.from_numpy(z['feats']), torch.from_numpy(z['lens']))[0]\n"
        f"assert (tokens.numpy() == np.load({str(tmp_path / 'want.npy')!r})).all()\n"
        "pkg = 'speech_tranformer_pytorch_tpu_torch.'\n"
        "code = tuple(pkg + n for n in ('models', 'config', 'decoding'))\n"
        "print(sorted(m for m in sys.modules if m.startswith(code)))\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """A tiny ``train_cli`` run (2 steps) on 4 synthetic utterances."""
    root = tmp_path_factory.mktemp("serving_cli")
    data, work = root / "data", root / "work"
    prepare_cli.main(["synthetic", "--device", "cpu", "--out", str(data),
                      "--num-train", "4", "--num-dev", "0", "--num-test", "0",
                      "--vocab-size", "16"])
    train_cli.main(["--preset", "tiny", "--data-dir", str(data), "--work-dir", str(work),
                    "--device", "cpu", "--set", "model.d_model=32",
                    "--set", "model.num_heads=2", "--set", "model.d_ff=64",
                    "--set", "model.num_encoder_layers=1",
                    "--set", "model.num_decoder_layers=1",
                    "--set", "model.subsample_channels=4", "--set", "train.batch_size=4",
                    "--set", "train.checkpoint_every_steps=2", "--max-steps", "2"])
    return root, data, work


def test_export_cli_end_to_end(trained_run):
    """export_cli: checkpoint -> artifact + flat-params npz; the loaded
    artifact, fed the npz, gives the live Recognizer's hypotheses."""
    from speech_tranformer_pytorch_tpu_torch.config import config_from_dict
    from speech_tranformer_pytorch_tpu_torch.data.features import extract_features
    from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances
    from speech_tranformer_pytorch_tpu_torch.recognize import load_recognizer

    root, _, work = trained_run
    cfg = config_from_dict(json.load(open(work / "config.json")))
    audio, lens = make_utterances(2, min_seconds=0.6, max_seconds=0.8, seed=4)
    feats, flens = extract_features(audio, lens, cfg.features, device="cpu")
    out = root / "dec.pt2"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        export_cli.main(["--work-dir", str(work), "--out", str(out), "--batch-size", "2",
                         "--frames", str(feats.shape[1]), "--beam", "3",
                         "--max-len", "6", "--device", "cpu"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["artifact"] == str(out) and line["bytes"] == out.stat().st_size > 0
    npz = np.load(str(out) + ".params.npz")
    assert len(npz.files) == line["num_param_leaves"]
    flat = [torch.from_numpy(npz[k]) for k in sorted(npz.files)]
    assert all(x.dtype == torch.float32 for x in flat)

    tokens, lengths, _ = load_exported(out.read_bytes())(
        flat, feats.float(), flens.to(torch.int32))
    assert tuple(tokens.shape) == (2, 3, 6) and tuple(lengths.shape) == (2, 3)
    rec = load_recognizer(cfg, str(work / "checkpoints"), device="cpu")
    live = rec.decode_batch(audio, lens, beam_size=3, max_len=6,
                            alpha=cfg.decode.length_penalty)
    hyps = [[t for t in tokens[i, 0, :lengths[i, 0]].tolist() if t != 2] for i in range(2)]
    assert hyps == live
