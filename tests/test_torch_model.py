"""Port model against the JAX package on the same weights.

One seeded flax init of the tiny preset per ``normalize_before`` setting is
converted with ``convert.params_from_jax``; encoder memory, teacher-forced
logits and two lineage decode steps must agree in float32 within 1e-4
(summation order and the matmul backend are the only differences). The
converter must round-trip the flax tree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import get_config as jax_get_config  # noqa: E402
from speech_tranformer_pytorch_tpu.models import SpeechTransformer as JaxModel  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import (  # noqa: E402
    params_from_jax, params_to_jax)
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=[True, False], ids=["pre_ln", "post_ln"])
def pair(request):
    over = {"model.normalize_before": request.param}
    jcfg, cfg = jax_get_config("tiny", **over), get_config("tiny", **over)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 120, 80)).astype(np.float32)
    frame_lens = np.array([120, 87], np.int32)
    targets = rng.integers(3, cfg.model.vocab_size, size=(2, 7)).astype(np.int32)
    tgt_lens = np.array([7, 4], np.int32)
    jmodel = JaxModel(jcfg.model)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(feats),
                            jnp.asarray(frame_lens), jnp.asarray(targets),
                            jnp.asarray(tgt_lens))
    tree = jax.tree.map(np.asarray, variables)
    model = SpeechTransformer(cfg.model).eval()
    model.load_state_dict(params_from_jax(tree, cfg.model))
    inputs = dict(feats=feats, frame_lens=frame_lens, targets=targets,
                  tgt_lens=tgt_lens)
    return cfg, jmodel, variables, tree, model, inputs


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_convert_round_trip_is_exact(pair):
    cfg, _, _, tree, model, _ = pair
    back = params_to_jax(params_from_jax(tree, cfg.model), cfg.model)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    sd = model.state_dict()
    again = params_from_jax(params_to_jax(sd, cfg.model), cfg.model)
    assert sorted(again) == sorted(sd)
    for name, value in sd.items():
        assert torch.equal(again[name], value), name


def test_encoder_and_teacher_forced_logits_match(pair):
    _, jmodel, variables, _, model, x = pair
    jmem, jlens = jmodel.apply(variables, jnp.asarray(x["feats"]),
                               jnp.asarray(x["frame_lens"]), method=JaxModel.encode)
    jlogits = jmodel.apply(variables, *(jnp.asarray(x[k]) for k in
                                        ("feats", "frame_lens", "targets", "tgt_lens")))
    with torch.no_grad():
        mem, lens = model.encode(_t(x["feats"]), _t(x["frame_lens"]))
        logits = model(*(_t(x[k]) for k in ("feats", "frame_lens", "targets",
                                            "tgt_lens")))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    # Memory is zeroed past each length in both packages: compared in full.
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), **TOL)
    assert logits.dtype == torch.float32
    # The port's attention has flash semantics (keys masked by length, query
    # rows not masked), as the JAX flash path does on a TPU; the JAX dot path
    # here gives a padded target row uniform weights instead. The loss
    # weights those rows 0, so only valid target positions must agree.
    got, want = logits.numpy(), np.asarray(jlogits)
    for b, n in enumerate(x["tgt_lens"]):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)
    assert np.isfinite(got).all()


def test_decode_steps_match(pair):
    """Two lineage decode steps at beam 3: logits of both steps, with a
    non-identity lineage table at the second."""
    _, jmodel, variables, _, model, x = pair
    k, max_len = 3, 8
    jmem, jlens = jmodel.apply(variables, jnp.asarray(x["feats"]),
                               jnp.asarray(x["frame_lens"]), method=JaxModel.encode)
    jcache = jmodel.apply(variables, jmem, max_len, k, method=JaxModel.init_cache)
    with torch.no_grad():
        mem, lens = model.encode(_t(x["feats"]), _t(x["frame_lens"]))
        cache = model.init_cache(mem, max_len, k)
    rng = np.random.default_rng(5)
    lineage = np.broadcast_to(np.arange(k, dtype=np.int32)[None, :, None],
                              (2, k, max_len)).copy()
    for i in range(2):
        tokens = rng.integers(3, 60, size=2 * k).astype(np.int32)
        jlogits, jcache = jmodel.apply(
            variables, jnp.asarray(tokens), jnp.int32(i), jcache, jlens, k,
            jnp.asarray(lineage), method=JaxModel.decode_step)
        with torch.no_grad():
            logits, cache = model.decode_step(_t(tokens), torch.tensor(i, dtype=torch.int32),
                                              cache, lens, k, _t(lineage))
        assert logits.shape == (2 * k, 64)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        lineage[:, :, :i + 1] = rng.integers(0, k, size=(2, k, i + 1))
