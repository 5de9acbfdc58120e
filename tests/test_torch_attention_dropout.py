"""Port attention dropout, routed as the JAX package routes it: with
``dropout_rate > 0 and not deterministic`` ``interface.flash_attention``
sends attention to the port's ``dot_product_attention`` (JAX
``models/modules.py:383-412``), every other call to the flash path.

- The dot core equals JAX's at ``deterministic=True`` with a bias, at 1e-5
  in f32 (also in bf16 inputs at bf16 rounding).
- With dropout on, the kept share of the attention weights is within 3σ of
  230/256 at rate 0.1, kept weights scaled by 256/230.
- The route: the flash path's plain version is not called when dropout is
  active, and is when it is not; the dot route masks keys by length,
  causally, and query rows given their lengths, as JAX's biases do.
- A narrow tiny train step with ``attention_dropout_rate=0.1`` gives a
  finite loss and gradients, and remat (layer and attention) on and off
  agree bit for bit."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.models.modules import (  # noqa: E402
    dot_product_attention as jax_dpa)
from speech_tranformer_pytorch_tpu.ops.masks import (  # noqa: E402
    mask_to_bias as jax_bias, padding_attention_mask as jax_pad_mask,
    self_attention_mask as jax_self_mask)
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels import flash_attention as flash  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels import interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.models.modules import (  # noqa: E402
    dot_product_attention)
from speech_tranformer_pytorch_tpu_torch.ops.dropout import step_generator  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.profile_train import smoke_audio_batch  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.pipeline import make_preprocess_fn  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.train import (  # noqa: E402
    create_train_state, loss_and_grads)


def _qkv(b=2, t=12, s=12, h=3, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, t, h, d), (b, s, h, d), (b, s, h, d))]


@pytest.mark.parametrize("causal", [False, True])
def test_dot_core_matches_jax_with_bias(causal):
    q, k, v = _qkv()
    lens = np.array([12, 7], np.int32)
    mask = (jax_self_mask(jnp.asarray(lens), 12, causal=True) if causal
            else jax_pad_mask(12, jnp.asarray(lens), 12))
    bias = np.array(jax_bias(mask))
    want = np.asarray(jax_dpa(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(bias)))
    got = dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                torch.from_numpy(bias), deterministic=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # The interface's own bias (key and query lengths, causal) is JAX's.
    mine = interface._attention_bias(12, 12, torch.from_numpy(lens), causal,
                                     torch.from_numpy(lens) if causal else None)
    assert np.array_equal(mine.numpy(), np.broadcast_to(bias, mine.shape))


def test_dot_core_bf16_matches_jax():
    q, k, v = _qkv(seed=1)
    jq = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = np.asarray(jax_dpa(*jq, None), np.float32)
    got = dot_product_attention(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                                None).float().numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_dropout_keeps_230_of_256_of_the_weights():
    b, h, t = 4, 4, 64
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(b, t, h, t, generator=g), torch.randn(b, t, h, t, generator=g)
    eye = torch.eye(t).expand(b, h, t, t).permute(0, 2, 1, 3)     # V = I: out = weights
    w = dot_product_attention(q, k, eye, None).permute(0, 2, 1, 3)
    out = dot_product_attention(q, k, eye, None, dropout_rate=0.1, deterministic=False,
                                generator=step_generator(0, 0, "cpu")).permute(0, 2, 1, 3)
    kept = out != 0
    p, n = 230 / 256, kept.numel()
    assert abs(float(kept.float().mean()) - p) <= 3 * math.sqrt(p * (1 - p) / n)
    np.testing.assert_allclose(out[kept].numpy(), (w[kept] * (256 / 230)).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("rate,deterministic,dot", [(0.1, False, True), (0.1, True, False),
                                                     (0.0, False, False)])
def test_route(rate, deterministic, dot, monkeypatch):
    calls = {"flash": 0}
    real = flash.flash_attention_reference

    def spy(*a, **kw):
        calls["flash"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(flash, "flash_attention_reference", spy)
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    lens = torch.tensor([12, 7])
    out = interface.flash_attention(q, k, v, kv_lengths=lens, causal=False,
                                    dropout_rate=rate, deterministic=deterministic,
                                    generator=step_generator(0, 1, "cpu"))
    assert calls["flash"] == (0 if dot else 1)
    assert out.shape == q.shape
    if dot:   # keys past the length get no weight: changing them changes nothing
        k2, v2 = k.clone(), v.clone()
        k2[1, 7:], v2[1, 7:] = 100.0, 100.0
        again = interface.flash_attention(q, k2, v2, kv_lengths=lens, causal=False,
                                          dropout_rate=rate, deterministic=False,
                                          generator=step_generator(0, 1, "cpu"))
        assert torch.equal(out, again)


def test_train_step_with_attention_dropout():
    over = {"model.num_encoder_layers": 2, "model.num_decoder_layers": 2,
            "model.d_model": 64, "model.num_heads": 2, "model.d_ff": 128,
            "model.subsample_channels": 8, "model.attention_dropout_rate": 0.1}
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        results = []
        for remat in (False, True):
            cfg = get_config("tiny", **over, **{"model.remat": remat,
                                                "model.attention_remat": remat})
            state = create_train_state(cfg, device="cpu", seed=1)
            batch = make_preprocess_fn(cfg.features)(
                smoke_audio_batch(cfg, 2, device="cpu", seconds=(1.0, 1.5)), "cpu")
            results.append(loss_and_grads(cfg, state, batch, 3))
    finally:
        torch.set_num_threads(n)
    (g0, m0), (g1, m1) = results
    assert math.isfinite(float(m0["loss"]))
    assert all(bool(torch.isfinite(g).all()) for g in g0.values())
    assert torch.equal(m0["loss"], m1["loss"])
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
