"""The port's sharded beam and greedy decoding and ``distributed_topk``
against the JAX package's ``parallel/decode.py`` and
``parallel/beam_exchange.py``.

Both decode four seeded utterances with the same flax init of a small
tiny-preset model (f32), with the batch over ``data`` and the parameters
over ``model``: the port through ``Recognizer(mesh=...).decode_result``
(its fbank of each data rank's rows, then ``make_sharded_beam_decode`` /
``make_sharded_greedy_decode``) on gloo ranks at mesh (2, 2) and (2, 1)
(two spawns for the module; the ranks import nothing of JAX), JAX's
sharded builders on the fake CPU mesh of the same shape, fed the port's
fbank features of the whole batch as numpy.
Beam 5 and greedy tokens and lengths are exact, against JAX's sharded
decode and against the port's unsharded decode; beam scores within 1e-5.
``distributed_topk`` over 2 model ranks equals JAX's and
``topk_stable`` of the whole row, tie order included; ``dp_split_utterances``
equals JAX's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.features import extract_features  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.decoding import (  # noqa: E402
    beam_decode, greedy_decode)
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.ops.topk import topk_stable  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.parallel.beam_exchange import (  # noqa: E402
    distributed_topk, dp_split_utterances)
from speech_tranformer_pytorch_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, spawn_ranks)
from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer  # noqa: E402

OVER = {"model.vocab_size": 32, "model.d_model": 64, "model.num_heads": 4,
        "model.d_ff": 128, "model.num_encoder_layers": 2, "model.num_decoder_layers": 2,
        "model.subsample_channels": 8, "model.dropout_rate": 0.0}
SHAPES = ((2, 2), (2, 1))
BEAM, MAX_LEN, TOPK = 5, 8, 6


def _cfg(tp, get=get_config):
    return get("tiny", **dict(OVER, **{"mesh.model_axis": tp}))


def _scores():
    """[3, 24] candidate scores with ties inside and across the two
    vocabulary shards."""
    rng = np.random.default_rng(31)
    x = rng.integers(0, 6, size=(3, 24)).astype(np.float32)
    x[0, [1, 13, 20]] = 9.0
    return x


def _decode_rank(rank, tp, params, audio, alens):
    torch.set_num_threads(1)
    cfg = _cfg(tp)
    mesh = make_mesh(cfg.mesh, device="cpu")
    rec = Recognizer(cfg, params, mesh=mesh)
    out = {name: rec.decode_result(audio, alens, beam_size=beam, max_len=MAX_LEN,
                                   alpha=1.0)
           for name, beam in (("beam", BEAM), ("greedy", 1))}
    if tp > 1:
        scores = torch.from_numpy(_scores())
        out["topk"] = distributed_topk(scores.chunk(tp, dim=1)[mesh.model_index],
                                       TOPK, mesh)
    return out


@pytest.fixture(scope="module")
def decodes():
    import jax
    import jax.numpy as jnp

    from speech_tranformer_pytorch_tpu.config import get_config as jax_get_config
    from speech_tranformer_pytorch_tpu.data.pipeline import Batch
    from speech_tranformer_pytorch_tpu.parallel import distributed_topk as jax_topk
    from speech_tranformer_pytorch_tpu.parallel import make_mesh as jax_make_mesh
    from speech_tranformer_pytorch_tpu.parallel.decode import (
        make_sharded_beam_decode as jax_beam, make_sharded_greedy_decode as jax_greedy)
    from speech_tranformer_pytorch_tpu.train import build_model, init_params
    from speech_tranformer_pytorch_tpu_torch.convert import params_from_jax

    cfg = _cfg(1)
    audio, alens = make_utterances(4, min_seconds=0.6, max_seconds=1.2, seed=41)
    feats, lens = extract_features(audio, alens, cfg.features, device="cpu")
    feats, lens = feats.numpy(), lens.numpy().astype(np.int32)
    jcfg = _cfg(1, jax_get_config)
    example = Batch(jnp.asarray(feats), jnp.asarray(lens), jnp.ones((4, 4), jnp.int32),
                    jnp.ones((4, 4), jnp.int32), jnp.full((4,), 4, jnp.int32))
    jparams = jax.jit(lambda k: init_params(jcfg, k, example))(jax.random.PRNGKey(5))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg.model)

    got, want = {}, {}
    for dp, tp in SHAPES:
        got[(dp, tp)] = spawn_ranks(_decode_rank, dp * tp, tp, params, audio, alens)
        mesh = jax_make_mesh(model_axis_size=tp, devices=jax.devices()[:dp * tp])
        model = build_model(_cfg(tp, jax_get_config), mesh=mesh)
        beam = jax_beam(model, mesh, beam_size=BEAM, max_len=MAX_LEN)(jparams)(
            jparams, jnp.asarray(feats), jnp.asarray(lens))
        greedy = jax_greedy(model, mesh, max_len=MAX_LEN)(jparams)(
            jparams, jnp.asarray(feats), jnp.asarray(lens))
        want[(dp, tp)] = dict(beam=[np.asarray(x) for x in (beam.tokens, beam.lengths,
                                                              beam.scores)],
                              greedy=[np.asarray(x) for x in greedy])
    mesh = jax_make_mesh(model_axis_size=2, devices=jax.devices()[:2])
    want["topk"] = [np.asarray(x) for x in jax_topk(jnp.asarray(_scores()), TOPK, mesh)]

    model = SpeechTransformer(cfg.model)
    model.load_state_dict(params)
    model.eval()
    f, l = torch.from_numpy(feats), torch.from_numpy(lens)
    want["single"] = dict(
        beam=beam_decode(model, f, l, beam_size=BEAM, max_len=MAX_LEN, device="cpu"),
        greedy=greedy_decode(model, f, l, max_len=MAX_LEN, device="cpu"))
    return got, want


def _greedy_lists(tokens, lengths):
    return [tokens[i, :lengths[i]].tolist() for i in range(len(lengths))]


@pytest.mark.parametrize("shape", SHAPES, ids=["dp2_tp2", "dp2_tp1"])
def test_sharded_beam_matches_jax_and_single_device(decodes, shape):
    got, want = decodes
    tokens, lengths, scores = want[shape]["beam"]
    single = want["single"]["beam"]
    for rank in got[shape]:
        r = rank["beam"]
        np.testing.assert_array_equal(r.tokens.numpy(), tokens)
        np.testing.assert_array_equal(r.lengths.numpy(), lengths)
        np.testing.assert_allclose(r.scores.numpy(), scores, rtol=1e-5, atol=1e-5)
        assert torch.equal(r.tokens, single.tokens) and torch.equal(r.lengths, single.lengths)


@pytest.mark.parametrize("shape", SHAPES, ids=["dp2_tp2", "dp2_tp1"])
def test_sharded_greedy_matches_jax_and_single_device(decodes, shape):
    got, want = decodes
    jt, jl = want[shape]["greedy"]
    single = want["single"]["greedy"]
    for rank in got[shape]:
        r = rank["greedy"]
        np.testing.assert_array_equal(r.lengths.numpy(), jl)
        assert _greedy_lists(r.tokens.numpy(), r.lengths.numpy()) == _greedy_lists(jt, jl)
        assert torch.equal(r.tokens, single.tokens)


def test_distributed_topk_matches_jax_with_ties(decodes):
    got, want = decodes
    vals, idx = topk_stable(torch.from_numpy(_scores()), TOPK)
    for rank in got[(2, 2)]:
        v, i = rank["topk"]
        np.testing.assert_array_equal(v.numpy(), want["topk"][0])
        np.testing.assert_array_equal(i.numpy(), want["topk"][1])
        assert torch.equal(v, vals) and torch.equal(i, idx)


@pytest.mark.parametrize("n,size", [(10, 4), (8, 2), (3, 4)])
def test_dp_split_utterances_matches_jax(n, size):
    from speech_tranformer_pytorch_tpu.parallel.beam_exchange import (
        dp_split_utterances as jax_split)

    for i in range(size):
        assert dp_split_utterances(n, size, i) == jax_split(n, size, i)
