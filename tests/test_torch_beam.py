"""Port beam search and Recognizer against the JAX package on the same
converted weights (tiny preset, float32, CPU): identical tokens and
lengths, scores within 1e-4. The JAX side runs as its own tests run it on
the CPU (jnp reference paths)."""

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
from speech_tranformer_pytorch_tpu.recognize import Recognizer as JaxRecognizer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import params_from_jax  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.decoding import (  # noqa: E402
    beam_decode, best_hypotheses)
from speech_tranformer_pytorch_tpu_torch.kernels import interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer  # noqa: E402

BEAM, MAX_LEN, ALPHA = 5, 12, 1.0


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_get_config("tiny"), get_config("tiny")
    audio, lens = make_utterances(3, min_seconds=0.8, max_seconds=1.6, seed=7)
    feats, frame_lens = jax_extract_features(jnp.asarray(audio), jnp.asarray(lens),
                                             jcfg.features)
    jmodel = JaxModel(jcfg.model)
    variables = jmodel.init(jax.random.PRNGKey(3), feats, frame_lens,
                            jnp.ones((3, 4), jnp.int32), jnp.full((3,), 4, jnp.int32))
    params = params_from_jax(jax.tree.map(np.asarray, variables), cfg.model)
    return jcfg, cfg, jmodel, variables, params, audio, lens, feats, frame_lens


def test_beam_decode_matches_jax(setup):
    _, cfg, jmodel, variables, params, _, _, feats, frame_lens = setup
    want = jax.jit(lambda p, f, l: jax_beam_decode(
        jmodel, p, f, l, beam_size=BEAM, max_len=MAX_LEN, alpha=ALPHA))(
        variables, feats, frame_lens)
    model = SpeechTransformer(cfg.model).eval()
    model.load_state_dict(params)
    before = dict(interface.launch_counts())
    got = beam_decode(model, np.array(feats), np.array(frame_lens),
                      beam_size=BEAM, max_len=MAX_LEN, alpha=ALPHA, device="cpu")
    assert interface.launch_counts() == before
    assert 0 < got.steps <= MAX_LEN
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-4, atol=1e-4)
    assert best_hypotheses(got) == [
        np.asarray(want.tokens)[i, 0, :int(want.lengths[i, 0])].tolist()
        for i in range(3)]


def test_recognizer_decode_batch_matches_jax(setup):
    jcfg, cfg, _, variables, params, audio, lens, _, _ = setup
    b = audio.shape[0]
    batch = AudioBatch(audio=jnp.asarray(audio), sample_lens=jnp.asarray(lens),
                       targets_in=jnp.zeros((b, 1), jnp.int32),
                       targets_out=jnp.zeros((b, 1), jnp.int32),
                       target_lens=jnp.ones((b,), jnp.int32),
                       valid=jnp.ones((b,), bool))
    want = JaxRecognizer(jcfg, variables).decode_batch(
        batch, beam_size=BEAM, max_len=MAX_LEN, alpha=ALPHA)
    rec = Recognizer(cfg, params, device="cpu")
    got = rec.decode_batch(audio, lens, beam_size=BEAM, max_len=MAX_LEN, alpha=ALPHA)
    assert got == want
    assert rec.last_steps > 0
