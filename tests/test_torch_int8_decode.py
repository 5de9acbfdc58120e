"""Int8 serving of the port against the JAX package (tiny preset, CPU).

Both sides start from the same f32 weights (channel-varying magnitudes,
nonzero biases) and quantize them themselves; the JAX side serves through
``ops.quantize.decode_variables`` with ``ST_TPU_INT8_MIN_WEIGHT_BYTES=0``,
so every int8 decoder dense takes its kernel math, as the port does at
every size (it has no size gate). Compared: the int8 cross-K/V cache, one
decode step's logits (f32 within 1e-4; bf16 within the bound stated at
the test), ``beam_decode`` at beam 5 and ``Recognizer`` at beam 5 and
beam 1 (tokens and lengths identical, f32 scores within 1e-4). A loose
check against JAX's default threshold, where the tiny preset's layers
take the dequantized-weight path instead, documents that the two paths
round differently (logits within 0.05, the bound of
``tests/test_int8_dense.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import get_config as jax_get_config  # noqa: E402
from speech_tranformer_pytorch_tpu.data.features import (  # noqa: E402
    extract_features as jax_extract_features)
from speech_tranformer_pytorch_tpu.data.pipeline import AudioBatch  # noqa: E402
from speech_tranformer_pytorch_tpu.decoding import beam_decode as jax_beam_decode  # noqa: E402
from speech_tranformer_pytorch_tpu.models import SpeechTransformer as JaxModel  # noqa: E402
from speech_tranformer_pytorch_tpu.ops.quantize import (  # noqa: E402
    decode_variables, quantize_params as jax_quantize)
from speech_tranformer_pytorch_tpu.recognize import Recognizer as JaxRecognizer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import params_from_jax  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.decoding import beam_decode  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels import interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.ops.quantize import (  # noqa: E402
    decode_model, quantize_params)
from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer  # noqa: E402

BEAM, MAX_LEN, ALPHA = 5, 12, 1.0
INT8 = {"decode.int8_weights": True, "decode.int8_kv_cache": True}


def varied(tree, seed=0):
    """Channel-varying magnitudes on every kernel and nonzero biases, so a
    misrouted scale or bias shows."""
    rng = np.random.default_rng(seed)

    def f(path, w):
        w = np.asarray(w, np.float32)
        if "bias" in jax.tree_util.keystr(path):
            return (0.1 * rng.standard_normal(w.shape)).astype(np.float32)
        if w.ndim >= 2:
            return w * (1.0 + 0.5 * np.cos(np.arange(w.shape[-1], dtype=np.float32)))
        return w
    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def kernel_math():
    """The JAX int8 denses take their kernel math at every size."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ST_TPU_INT8_MIN_WEIGHT_BYTES", "0")
        yield


@pytest.fixture(scope="module")
def setup(kernel_math):
    jcfg, cfg = jax_get_config("tiny"), get_config("tiny")
    audio, lens = make_utterances(3, min_seconds=0.8, max_seconds=1.6, seed=5)
    feats, frame_lens = jax_extract_features(jnp.asarray(audio), jnp.asarray(lens),
                                             jcfg.features)
    jmodel = JaxModel(jcfg.model)
    variables = jmodel.init(jax.random.PRNGKey(2), feats, frame_lens,
                            jnp.ones((3, 4), jnp.int32), jnp.full((3,), 4, jnp.int32))
    tree = varied(jax.tree.map(np.asarray, variables))
    params = params_from_jax(tree, cfg.model)
    return jcfg, cfg, jmodel, tree, params, audio, lens, feats, frame_lens


def _jax_vars(tree, dtype):
    qp, sc = jax_quantize(tree, embedding_rows=True)
    return decode_variables(qp, sc, dtype)


def _port_model(cfg, params, dtype):
    qp, sc = quantize_params(params, cfg.model, embedding_rows=True)
    return decode_model(cfg.model, qp, sc, dtype).eval()


def _jax_step(jmodel, var, memory, mem_lens, tokens, kv, steps=2):
    cache = jmodel.apply(var, memory, 6, 1, kv, method=JaxModel.init_cache)
    out = []
    for i, tok in enumerate(tokens[:steps]):
        lg, cache = jmodel.apply(var, jnp.asarray(tok), jnp.int32(i), cache, mem_lens,
                                 method=JaxModel.decode_step)
        out.append(np.asarray(lg))
    return out, cache


def _port_step(model, memory, mem_lens, tokens, kv, steps=2):
    b = memory.shape[0]
    lineage = torch.zeros((b, 1, 6), dtype=torch.int32)
    with torch.no_grad():
        cache = model.init_cache(memory, 6, 1, kv)
        out = []
        for i, tok in enumerate(tokens[:steps]):
            lg, cache = model.decode_step(torch.from_numpy(tok),
                                          torch.tensor(i, dtype=torch.int32), cache,
                                          mem_lens, 1, lineage)
            out.append(lg.numpy())
    return out, cache


def _tokens(b, v):
    return [np.full((b,), 1, np.int32), np.arange(3, 3 + b, dtype=np.int32) % v]


def test_int8_kv_cache_matches_jax(setup):
    _, cfg, jmodel, tree, params, _, _, feats, frame_lens = setup
    var = _jax_vars(tree, jnp.float32)
    memory, mem_lens = jmodel.apply(var, feats, frame_lens, method=JaxModel.encode)
    model = _port_model(cfg, params, torch.float32)
    mem_t = torch.from_numpy(np.array(memory))       # one memory for both
    _, jcache = _jax_step(jmodel, var, memory, mem_lens, [], True, 0)
    with torch.no_grad():
        cache = model.init_cache(mem_t, 6, 1, True)
    for i in range(cfg.model.num_decoder_layers):
        for name in ("cross_k", "cross_v"):
            got, want = cache[f"layer_{i}"][name], np.asarray(jcache[f"layer_{i}"][name])
            assert got.dtype == torch.int8 and got.shape == want.shape
            diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
            # Rounding ties of values that differ in the last f32 bit.
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            s = cache[f"layer_{i}"][name + "_scale"]
            assert s.shape == (3, cfg.model.num_heads, 1, cfg.model.head_dim)
            np.testing.assert_allclose(s.numpy(), np.asarray(
                jcache[f"layer_{i}"][name + "_scale"]), rtol=1e-5)


@pytest.mark.parametrize("int8_kv", [True, False])
def test_int8_decode_step_logits_match_jax_f32(setup, int8_kv):
    _, cfg, jmodel, tree, params, _, _, feats, frame_lens = setup
    var = _jax_vars(tree, jnp.float32)
    memory, mem_lens = jmodel.apply(var, feats, frame_lens, method=JaxModel.encode)
    want, _ = _jax_step(jmodel, var, memory, mem_lens, _tokens(3, 64), int8_kv)
    model = _port_model(cfg, params, torch.float32)
    with torch.no_grad():
        mem_t, ml_t = model.encode(torch.from_numpy(np.array(feats)),
                                   torch.from_numpy(np.array(frame_lens)))
    np.testing.assert_allclose(mem_t.numpy(), np.asarray(memory), rtol=1e-4, atol=1e-4)
    got, _ = _port_step(model, mem_t, ml_t, _tokens(3, 64), int8_kv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_int8_decode_step_logits_match_jax_bf16(setup):
    """bf16 compute: both sides round every activation to bf16, at the same
    places but after differently ordered f32 sums, so a value near a bf16
    rounding boundary can land one ulp apart and carry through the layers.
    Bound: 0.1 absolute on logits of magnitude up to ~8 (measured 0.012
    and 0.025 at the two steps)."""
    jcfg, cfg, jmodel, tree, params, _, _, feats, frame_lens = setup
    jmodel = JaxModel(dataclasses.replace(jcfg.model, dtype="bfloat16"))
    var = _jax_vars(tree, jnp.bfloat16)
    memory, mem_lens = jmodel.apply(var, feats, frame_lens, method=JaxModel.encode)
    want, _ = _jax_step(jmodel, var, memory, mem_lens, _tokens(3, 64), True)
    model = _port_model(cfg, params, torch.bfloat16)
    mem_t = torch.from_numpy(np.array(memory.astype(jnp.float32))).to(torch.bfloat16)
    got, _ = _port_step(model, mem_t, torch.from_numpy(np.array(mem_lens)),
                        _tokens(3, 64), True)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() < 0.1


def test_int8_logits_near_jax_default_threshold(setup):
    """JAX's default 2 MiB threshold sends every tiny-preset dense to the
    dequantized-weight path, which rounds w·s before the product: the port
    (kernel math everywhere) stays within 0.05 of it."""
    _, cfg, jmodel, tree, params, _, _, feats, frame_lens = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("ST_TPU_INT8_MIN_WEIGHT_BYTES")
        var = _jax_vars(tree, jnp.float32)
        memory, mem_lens = jmodel.apply(var, feats, frame_lens, method=JaxModel.encode)
        want, _ = _jax_step(jmodel, var, memory, mem_lens, _tokens(3, 64), True)
    model = _port_model(cfg, params, torch.float32)
    got, _ = _port_step(model, torch.from_numpy(np.array(memory)),
                        torch.from_numpy(np.array(mem_lens)), _tokens(3, 64), True)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() < 0.05


def test_int8_beam_decode_matches_jax(setup):
    _, cfg, jmodel, tree, params, _, _, feats, frame_lens = setup
    var = _jax_vars(tree, jnp.float32)
    want = jax.jit(lambda p, f, l: jax_beam_decode(
        jmodel, p, f, l, beam_size=BEAM, max_len=MAX_LEN, alpha=ALPHA, int8_kv=True))(
        var, feats, frame_lens)
    model = _port_model(cfg, params, torch.float32)
    before = dict(interface.launch_counts())
    got = beam_decode(model, np.array(feats), np.array(frame_lens), beam_size=BEAM,
                      max_len=MAX_LEN, alpha=ALPHA, int8_kv=True, device="cpu")
    assert interface.launch_counts() == before
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("beam", [BEAM, 1])
def test_int8_recognizer_matches_jax(setup, beam):
    _, _, _, tree, params, audio, lens, _, _ = setup
    jcfg = jax_get_config("tiny", **INT8)
    cfg = get_config("tiny", **INT8)
    b = audio.shape[0]
    batch = AudioBatch(audio=jnp.asarray(audio), sample_lens=jnp.asarray(lens),
                       targets_in=jnp.zeros((b, 1), jnp.int32),
                       targets_out=jnp.zeros((b, 1), jnp.int32),
                       target_lens=jnp.ones((b,), jnp.int32),
                       valid=jnp.ones((b,), bool))
    want = JaxRecognizer(jcfg, tree).decode_batch(batch, beam_size=beam,
                                                  max_len=MAX_LEN, alpha=ALPHA)
    rec = Recognizer(cfg, params, device="cpu")
    assert rec.int8_kv
    assert got_int8_layers(rec.model) > 0
    got = rec.decode_batch(audio, lens, beam_size=beam, max_len=MAX_LEN, alpha=ALPHA)
    assert got == want


def got_int8_layers(model):
    from speech_tranformer_pytorch_tpu_torch.models.modules import Int8Linear
    return sum(isinstance(m, Int8Linear) for m in model.modules())


def test_recognizer_int8_scores_differ_from_float(setup):
    """The int8 flags change what is served: the beam scores move by the
    quantization error, away from the float model's and onto JAX's int8
    ones."""
    _, _, jmodel, tree, params, audio, lens, feats, frame_lens = setup
    scores = {}
    for name, over in (("float", {}), ("int8", INT8)):
        rec = Recognizer(get_config("tiny", **over), params, device="cpu")
        scores[name] = rec.decode_result(audio, lens, beam_size=BEAM, max_len=MAX_LEN,
                                         alpha=ALPHA).scores.numpy()
    want = jax.jit(lambda p, f, l: jax_beam_decode(
        jmodel, p, f, l, beam_size=BEAM, max_len=MAX_LEN, alpha=ALPHA, int8_kv=True))(
        _jax_vars(tree, jnp.float32), feats, frame_lens)
    np.testing.assert_allclose(scores["int8"], np.asarray(want.scores), rtol=1e-4,
                               atol=1e-4)
    assert np.abs(scores["int8"] - scores["float"]).max() > 1e-3
