"""JAX's decode options in the port (tiny preset, float32, CPU):
``early_stop=False`` runs every step and changes no result, in the port
and against JAX's ``early_stop=False``; ``use_lineage=False`` (the self
cache gathered by beam every step, plain masked attention) equals JAX's
``use_lineage=False`` and the port's lineage route. The decoder's <eos>
embedding row is scaled so that some hypotheses end in <eos> (at the
larger scale every greedy row at step 0, so its early stop cuts steps;
random weights seldom let the beam search's bound stop it). Also
``torch.library.opcheck`` of the three serving kernels' custom ops with
CPU inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import get_config as jax_get_config  # noqa: E402
from speech_tranformer_pytorch_tpu.data.features import (  # noqa: E402
    extract_features as jax_extract_features)
from speech_tranformer_pytorch_tpu.decoding import (  # noqa: E402
    beam_decode as jax_beam_decode, greedy_decode_jit)
from speech_tranformer_pytorch_tpu.models import SpeechTransformer as JaxModel  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import params_from_jax  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.decoding import (  # noqa: E402
    beam_decode, greedy_decode)
from speech_tranformer_pytorch_tpu_torch.decoding.beam import EOS  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels import custom_ops  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402

BEAM, MAX_LEN, ALPHA = 4, 12, 1.0


def _models(eos_scale):
    jcfg, cfg = jax_get_config("tiny"), get_config("tiny")
    audio, lens = make_utterances(3, min_seconds=0.8, max_seconds=1.6, seed=11)
    feats, frame_lens = jax_extract_features(jnp.asarray(audio), jnp.asarray(lens),
                                             jcfg.features)
    jmodel = JaxModel(jcfg.model)
    variables = jax.tree.map(np.array, jmodel.init(
        jax.random.PRNGKey(0), feats, frame_lens, jnp.ones((3, 4), jnp.int32),
        jnp.full((3,), 4, jnp.int32)))
    variables["params"]["decoder"]["embed"]["embedding"][EOS] *= eos_scale
    model = SpeechTransformer(cfg.model).eval()
    model.load_state_dict(params_from_jax(variables, cfg.model))
    return jmodel, variables, model, np.array(feats), np.array(frame_lens)


@pytest.fixture(scope="module")
def setup():
    return _models(2.0)


def _port_beam(setup, **kw):
    _, _, model, feats, lens = setup
    return beam_decode(model, feats, lens, beam_size=BEAM, max_len=MAX_LEN, alpha=ALPHA,
                       device="cpu", **kw)


def _jax_beam(setup, **kw):
    jmodel, variables, _, feats, lens = setup
    return jax.jit(lambda p, f, l: jax_beam_decode(
        jmodel, p, f, l, beam_size=BEAM, max_len=MAX_LEN, alpha=ALPHA, **kw))(
        variables, jnp.asarray(feats), jnp.asarray(lens))


def _equal(got, want, scores=True):
    np.testing.assert_array_equal(np.asarray(got.tokens), np.asarray(want.tokens))
    np.testing.assert_array_equal(np.asarray(got.lengths), np.asarray(want.lengths))
    if scores:
        np.testing.assert_allclose(np.asarray(got.scores), np.asarray(want.scores),
                                   rtol=1e-4, atol=1e-4)


def test_beam_early_stop_false_runs_every_step_with_the_same_result(setup):
    stopped = _port_beam(setup)
    full = _port_beam(setup, early_stop=False)
    assert full.steps == MAX_LEN
    _equal(full, stopped)
    assert torch.equal(full.scores, stopped.scores)


def test_beam_early_stop_false_matches_jax(setup):
    _equal(_port_beam(setup, early_stop=False), _jax_beam(setup, early_stop=False))


@pytest.mark.parametrize("early_stop", [True, False], ids=["early_stop", "fixed_trip"])
def test_use_lineage_false_matches_jax_and_the_lineage_route(setup, early_stop):
    got = _port_beam(setup, use_lineage=False, early_stop=early_stop)
    _equal(got, _jax_beam(setup, use_lineage=False, early_stop=early_stop))
    _equal(got, _port_beam(setup, early_stop=early_stop))


@pytest.mark.parametrize("eos_scale", [2.0, 3.0])
def test_greedy_early_stop_false(eos_scale):
    jmodel, variables, model, feats, lens = _models(eos_scale)
    stopped = greedy_decode(model, feats, lens, max_len=MAX_LEN, device="cpu")
    full = greedy_decode(model, feats, lens, max_len=MAX_LEN, device="cpu",
                         early_stop=False)
    assert full.steps == MAX_LEN
    assert stopped.steps == (1 if eos_scale == 3.0 else MAX_LEN)
    assert torch.equal(full.tokens, stopped.tokens)
    assert torch.equal(full.lengths, stopped.lengths)
    want_t, want_l = jax.jit(lambda p, f, l: greedy_decode_jit(
        jmodel, p, f, l, max_len=MAX_LEN, early_stop=False))(
        variables, jnp.asarray(feats), jnp.asarray(lens))
    np.testing.assert_array_equal(full.tokens.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(full.lengths.numpy(), np.asarray(want_l))


def _opcheck_cases():
    g = np.random.default_rng(3)
    f32 = lambda *s: torch.from_numpy(g.standard_normal(s).astype(np.float32))
    b, k, v, L, h, d = 2, 3, 40, 9, 2, 8
    lineage = torch.from_numpy(g.integers(0, k, (b, k, L)).astype(np.int32))
    lens = torch.tensor([7, 3], dtype=torch.int32)
    return [
        ("beam_candidate_topk", custom_ops.beam_candidate_topk,
         (f32(b * k, v), f32(b, k), 2 * k, 0, 1)),
        ("lineage_attention", custom_ops.lineage_attention,
         (f32(b * k, 1, h, d), f32(b * k, L, h, d), f32(b * k, L, h, d), lineage,
          torch.tensor(5, dtype=torch.int32), k)),
        ("flash_fwd", custom_ops.flash_fwd,
         (f32(b, h, 6, d), f32(b, h, 7, d), f32(b, h, 7, d), lens, False)),
        ("flash_fwd_causal_bf16", custom_ops.flash_fwd,
         tuple(f32(b, h, 7, 12).bfloat16() for _ in range(3)) + (lens, True)),
    ]


@pytest.mark.parametrize("case", _opcheck_cases(), ids=lambda c: c[0])
def test_opcheck(case):
    _, op, args = case
    torch.library.opcheck(op, args)
