"""Port greedy decoding against the JAX package (tiny preset, float32,
CPU): tokens and lengths identical to JAX ``greedy_decode``, and
``Recognizer(beam_size=1)`` equal to the JAX ``Recognizer``, which routes
beam 1 to greedy decoding. The EOS-row cases scale the decoder's <eos>
embedding row so that <eos> wins early: with random weights it never
does, and beam search and greedy decoding then agree by chance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import get_config as jax_get_config  # noqa: E402
from speech_tranformer_pytorch_tpu.data.features import (  # noqa: E402
    extract_features as jax_extract_features)
from speech_tranformer_pytorch_tpu.data.pipeline import AudioBatch  # noqa: E402
from speech_tranformer_pytorch_tpu.decoding import greedy_decode_jit  # noqa: E402
from speech_tranformer_pytorch_tpu.models import SpeechTransformer as JaxModel  # noqa: E402
from speech_tranformer_pytorch_tpu.recognize import Recognizer as JaxRecognizer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import params_from_jax  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.decoding import (  # noqa: E402
    greedy_decode, tokens_to_lists)
from speech_tranformer_pytorch_tpu_torch.decoding.beam import EOS, PAD  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels import interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer  # noqa: E402

MAX_LEN, ALPHA = 12, 1.0
EOS_SCALES = [1.0, 1.5, 2.0, 4.0]


@pytest.fixture(scope="module")
def base():
    jcfg, cfg = jax_get_config("tiny"), get_config("tiny")
    audio, lens = make_utterances(4, min_seconds=0.8, max_seconds=1.6, seed=0)
    feats, frame_lens = jax_extract_features(jnp.asarray(audio), jnp.asarray(lens),
                                             jcfg.features)
    jmodel = JaxModel(jcfg.model)
    variables = jmodel.init(jax.random.PRNGKey(0), feats, frame_lens,
                            jnp.ones((4, 4), jnp.int32), jnp.full((4,), 4, jnp.int32))
    tree = jax.tree.map(np.asarray, variables)
    decode = jax.jit(lambda p, f, l: greedy_decode_jit(jmodel, p, f, l, max_len=MAX_LEN))
    return jcfg, cfg, tree, audio, lens, feats, frame_lens, decode


def _scaled(tree, eos_scale):
    out = jax.tree.map(np.array, tree)
    out["params"]["decoder"]["embed"]["embedding"][EOS] *= eos_scale
    return out


@pytest.mark.parametrize("eos_scale", EOS_SCALES)
def test_greedy_decode_matches_jax(base, eos_scale):
    _, cfg, tree, _, _, feats, frame_lens, decode = base
    tree = _scaled(tree, eos_scale)
    want_t, want_l = decode(tree, feats, frame_lens)
    model = SpeechTransformer(cfg.model).eval()
    model.load_state_dict(params_from_jax(tree, cfg.model))
    before = dict(interface.launch_counts())
    got = greedy_decode(model, np.array(feats), np.array(frame_lens), max_len=MAX_LEN,
                        device="cpu")
    assert interface.launch_counts() == before
    want_t, want_l = np.asarray(want_t), np.asarray(want_l)
    np.testing.assert_array_equal(got.lengths.numpy(), want_l)
    # The port stops once every row has emitted <eos>; JAX's early stop
    # leaves the same <pad> tail in its buffer.
    np.testing.assert_array_equal(got.tokens.numpy(), want_t)
    assert 0 < got.steps <= MAX_LEN
    assert got.steps == MAX_LEN or bool((got.tokens == EOS).any(dim=1).all())
    assert tokens_to_lists(got) == [want_t[i, :want_l[i]].tolist() for i in range(4)]


def test_greedy_never_emits_pad_or_sos_and_pads_after_eos(base):
    _, cfg, tree, _, _, feats, frame_lens, _ = base
    model = SpeechTransformer(cfg.model).eval()
    model.load_state_dict(params_from_jax(_scaled(tree, 1.5), cfg.model))
    got = greedy_decode(model, np.array(feats), np.array(frame_lens), max_len=MAX_LEN,
                        device="cpu").tokens
    for row in got.tolist():
        end = row.index(EOS) if EOS in row else len(row)
        assert all(t not in (PAD, 1) for t in row[:end])
        assert all(t == PAD for t in row[end + 1:])


@pytest.mark.parametrize("eos_scale", [2.0, 1.0])
def test_recognizer_beam_1_matches_jax(base, eos_scale):
    jcfg, cfg, tree, audio, lens, _, _, _ = base
    tree = _scaled(tree, eos_scale)
    b = audio.shape[0]
    batch = AudioBatch(audio=jnp.asarray(audio), sample_lens=jnp.asarray(lens),
                       targets_in=jnp.zeros((b, 1), jnp.int32),
                       targets_out=jnp.zeros((b, 1), jnp.int32),
                       target_lens=jnp.ones((b,), jnp.int32),
                       valid=jnp.ones((b,), bool))
    want = JaxRecognizer(jcfg, tree).decode_batch(batch, beam_size=1, max_len=MAX_LEN,
                                                  alpha=ALPHA)
    rec = Recognizer(cfg, params_from_jax(tree, cfg.model), device="cpu")
    got = rec.decode_batch(audio, lens, beam_size=1, max_len=MAX_LEN, alpha=ALPHA)
    assert got == want
    if eos_scale == 2.0:          # <eos> wins at the first step in JAX too
        assert got == [[]] * b and rec.last_steps == 1
