"""The weight bridge on JAX's scanned encoder layout (``model.scan_layers``,
as the ``large`` and ``sharded`` presets set it): the JAX encoder keeps its
layers stacked in one ``nn.scan`` module, ``encoder/layers/layer/...``,
each leaf with a leading axis of length L; the decoder keeps
``decoder/layer_{i}``.

- A narrow JAX model built with ``scan_layers=True`` and ``remat=True``
  (3 encoder layers) goes through ``params_from_jax``: encoder memory and
  teacher-forced logits match JAX at 1e-4 on valid rows (the padded rows
  differ by design: flash semantics, ROADMAP §C).
- ``params_to_jax`` writes the stacked layout when ``cfg.scan_layers`` and
  the flat one otherwise; both round trips are exact, and layer i of the
  stack is the flat tree's ``layer_{i}``.
- ``adam_state_from_jax`` reads a scanned ``FusedAdamState`` with its f32
  master (``train.master_weights``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import get_config as jax_get_config  # noqa: E402
from speech_tranformer_pytorch_tpu.models import SpeechTransformer as JaxModel  # noqa: E402
from speech_tranformer_pytorch_tpu.ops.fused_adam import FusedAdam as JaxFusedAdam  # noqa: E402
from speech_tranformer_pytorch_tpu.ops.schedules import noam_schedule as jax_noam  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import (  # noqa: E402
    adam_state_from_jax, params_from_jax, params_to_jax)
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402

OVER = {"model.scan_layers": True, "model.remat": True, "model.num_encoder_layers": 3,
        "model.num_decoder_layers": 2, "model.d_model": 64, "model.num_heads": 2,
        "model.d_ff": 128, "model.subsample_channels": 8}


@pytest.fixture(scope="module")
def scanned():
    jcfg, cfg = jax_get_config("tiny", **OVER), get_config("tiny", **OVER)
    rng = np.random.default_rng(0)
    x = dict(feats=rng.standard_normal((2, 120, 80)).astype(np.float32),
             frame_lens=np.array([120, 87], np.int32),
             targets=rng.integers(3, cfg.model.vocab_size, size=(2, 7)).astype(np.int32),
             tgt_lens=np.array([7, 4], np.int32))
    jmodel = JaxModel(jcfg.model)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                     *(jnp.asarray(x[k]) for k in x))
    return cfg, jmodel, variables, jax.tree.map(np.asarray, variables), x


def test_the_tree_is_scanned(scanned):
    cfg, _, _, tree, _ = scanned
    enc = tree["params"]["encoder"]
    assert "layer_0" not in enc and "layer_0" in tree["params"]["decoder"]
    assert enc["layers"]["layer"]["self_attn"]["qkv"]["kernel"].shape == (3, 64, 3, 2, 32)


def test_scanned_weights_match_jax(scanned):
    cfg, jmodel, variables, tree, x = scanned
    model = SpeechTransformer(cfg.model).eval()
    model.load_state_dict(params_from_jax(tree, cfg.model))
    jmem, _ = jax.jit(lambda v, f, n: jmodel.apply(v, f, n, method=JaxModel.encode))(
        variables, jnp.asarray(x["feats"]), jnp.asarray(x["frame_lens"]))
    jlogits = jax.jit(jmodel.apply)(variables, *(jnp.asarray(x[k]) for k in x))
    t = lambda a: torch.from_numpy(a)
    with torch.no_grad():
        mem, _ = model.encode(t(x["feats"]), t(x["frame_lens"]))
        logits = model(*(t(x[k]) for k in x))
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), rtol=1e-4, atol=1e-4)
    for b, n in enumerate(x["tgt_lens"]):
        np.testing.assert_allclose(logits[b, :n].numpy(), np.asarray(jlogits)[b, :n],
                                   rtol=1e-4, atol=1e-4)
    assert bool(torch.isfinite(logits).all())


def _assert_trees_equal(a, b):
    fa, fb = (jax.tree_util.tree_flatten_with_path(x)[0] for x in (a, b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        np.testing.assert_array_equal(x, y)


def test_round_trips_in_both_layouts(scanned):
    cfg, _, _, tree, _ = scanned
    sd = params_from_jax(tree, cfg.model)
    _assert_trees_equal(params_to_jax(sd, cfg.model), {"params": tree["params"]})
    flat_cfg = cfg.model.replace(scan_layers=False)
    flat = params_to_jax(sd, flat_cfg)
    stack = tree["params"]["encoder"]["layers"]["layer"]
    for i in range(3):
        layer = flat["params"]["encoder"][f"layer_{i}"]
        _assert_trees_equal(layer, jax.tree.map(lambda s: s[i], stack))
    again = params_from_jax(flat, flat_cfg)
    assert sorted(again) == sorted(sd) and all(torch.equal(again[k], sd[k]) for k in sd)


def test_adam_state_with_master_from_a_scanned_tree(scanned):
    cfg, _, variables, tree, _ = scanned
    opt = JaxFusedAdam(jax_noam(64, 100, 1.0), moment_dtype="bfloat16", master_weights=True)

    @jax.jit
    def one_step(p32):
        grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01, jnp.bfloat16), p32)
        params = jax.tree.map(lambda p: p.astype(jnp.bfloat16), p32)
        return opt.update_apply(grads, opt.init(p32), params)[1]

    state = one_step(variables["params"])
    port = adam_state_from_jax(state, cfg.model)
    assert int(port.count) == 1 and port.master is not None
    want = params_from_jax(jax.tree.map(np.asarray, state.master), cfg.model)
    for k, w in want.items():
        assert port.master[k].dtype == torch.float32 and torch.equal(port.master[k], w), k
        assert port.mu[k].dtype == torch.bfloat16
    mu = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), state.mu),
                         cfg.model)
    assert all(torch.equal(port.mu[k].float(), mu[k]) for k in mu)
    assert not torch.equal(port.master["encoder.layers.2.ffn.fc1.weight"],
                           params_from_jax(tree, cfg.model)["encoder.layers.2.ffn.fc1.weight"])
