"""Port int8 quantization against the JAX package (tiny preset, CPU).

The port's ``quantize_params`` on its f32 ``state_dict`` must give int8
values and scales bit-equal to JAX ``quantize_params`` on the flax tree
(carried over by ``convert.quantized_from_jax``), with and without the
per-row embedding. Weights get channel-varying magnitudes (as
``tests/test_int8_dense.py`` does) and biases are nonzero, so a scale
group or a bias routed to the wrong place shows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import get_config as jax_get_config  # noqa: E402
from speech_tranformer_pytorch_tpu.models import SpeechTransformer as JaxModel  # noqa: E402
from speech_tranformer_pytorch_tpu.ops.quantize import (  # noqa: E402
    dequantize_params as jax_dequantize, max_abs_error as jax_max_abs_error,
    quantize_params as jax_quantize)
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import (  # noqa: E402
    params_from_jax, quantized_from_jax)
from speech_tranformer_pytorch_tpu_torch.models.modules import (  # noqa: E402
    Int8Embedding, Int8Linear)
from speech_tranformer_pytorch_tpu_torch.ops.quantize import (  # noqa: E402
    decode_model, dequantize_params, max_abs_error, quantize_params)


def varied(tree, seed=0):
    """Channel-varying magnitudes on every kernel and nonzero biases."""
    rng = np.random.default_rng(seed)

    def f(path, w):
        w = np.asarray(w, np.float32)
        name = jax.tree_util.keystr(path)
        if "bias" in name:      # multi-dimensional ones ([3, H, Dh]) included
            return (0.1 * rng.standard_normal(w.shape)).astype(np.float32)
        if w.ndim >= 2:
            return w * (1.0 + 0.5 * np.cos(np.arange(w.shape[-1], dtype=np.float32)))
        return w
    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = jax_get_config("tiny"), get_config("tiny")
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 64, 80)).astype(np.float32)
    jmodel = JaxModel(jcfg.model)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(feats),
                            jnp.array([64, 40], jnp.int32), jnp.ones((2, 4), jnp.int32),
                            jnp.full((2,), 4, jnp.int32))
    tree = varied(jax.tree.map(np.asarray, variables))
    return cfg, tree, params_from_jax(tree, cfg.model)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("embedding_rows", [False, True])
def test_quantize_params_bit_equal_to_jax(tiny, embedding_rows):
    cfg, tree, sd = tiny
    jq, js = jax_quantize(tree, embedding_rows=embedding_rows)
    want_q, want_s = quantized_from_jax(_np(jq), _np(js), cfg.model)
    got_q, got_s = quantize_params(sd, cfg.model, embedding_rows=embedding_rows)
    assert set(got_q) == set(sd) == set(want_q)
    assert set(got_s) == set(want_s)
    for name in sd:
        assert got_q[name].dtype == want_q[name].dtype, name
        assert torch.equal(got_q[name], want_q[name]), name
    for name in got_s:
        assert got_s[name].dtype == torch.float32
        assert torch.equal(got_s[name], want_s[name]), name
    assert ("decoder.embed.weight" in got_s) == embedding_rows
    # Which leaves are int8: every dense and conv kernel; no bias, norm or
    # (without embedding_rows) embedding.
    int8 = {n for n, t in got_q.items() if t.dtype == torch.int8}
    assert int8 == set(got_s)
    assert not any(n.endswith(".bias") or "ln" in n or "norm" in n for n in int8)
    assert "encoder.subsample.conv0.weight" in int8


def test_attention_scales_are_per_head_dim(tiny):
    """qkv [d, 3, H, Dh] and cross q/k/v [d, H, Dh] share one scale per Dh
    channel across q/k/v and heads: the JAX kernel's last axis."""
    cfg, _, sd = tiny
    _, scales = quantize_params(sd, cfg.model)
    h, dh = cfg.model.num_heads, cfg.model.head_dim
    qkv = scales["decoder.layers.0.self_attn.qkv.weight"].reshape(3 * h, dh)
    assert torch.equal(qkv, qkv[:1].expand_as(qkv))
    q = scales["decoder.layers.1.cross_attn.q.weight"].reshape(h, dh)
    assert torch.equal(q, q[:1].expand_as(q))
    assert len(torch.unique(qkv[0])) > 1
    out = scales["decoder.layers.0.self_attn.out.weight"]
    assert out.shape == (cfg.model.d_model,) and len(torch.unique(out)) > 1


def test_biases_stay_float_and_unchanged(tiny):
    cfg, _, sd = tiny
    qparams, _ = quantize_params(sd, cfg.model, embedding_rows=True)
    for name, t in sd.items():
        if name.endswith(".bias"):
            assert qparams[name].dtype == torch.float32
            assert torch.equal(qparams[name], t)
    assert float(sd["decoder.layers.0.self_attn.qkv.bias"].abs().max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_and_error_match_jax(tiny, dtype):
    cfg, tree, sd = tiny
    jq, js = jax_quantize(tree, embedding_rows=True)
    want = params_from_jax(_np(jax_dequantize(jq, js, getattr(jnp, dtype))), cfg.model)
    qparams, scales = quantize_params(sd, cfg.model, embedding_rows=True)
    got = dequantize_params(qparams, scales, getattr(torch, dtype))
    for name in scales:
        assert got[name].dtype == getattr(torch, dtype)
        assert torch.equal(got[name].float(), want[name].float()), name
    err = max_abs_error(sd, qparams, scales)
    assert err == pytest.approx(jax_max_abs_error(tree, jq, js), rel=1e-6)
    # |w - dq(w)| <= s/2 per output channel
    deq = dequantize_params(qparams, scales, torch.float32)
    for name, s in scales.items():
        bound = s.reshape((-1,) + (1,) * (sd[name].dim() - 1)) / 2 + 1e-7
        assert bool(((sd[name] - deq[name]).abs() <= bound).all()), name


def test_decode_model_keeps_decoder_int8(tiny):
    cfg, _, sd = tiny
    qparams, scales = quantize_params(sd, cfg.model, embedding_rows=True)
    model = decode_model(cfg.model, qparams, scales, torch.bfloat16)
    enc = model.encoder.state_dict()
    assert all(t.dtype == torch.bfloat16 for t in enc.values())
    # The encoder takes q.to(bf16) * s.to(bf16): the scale rounded to bf16.
    w = qparams["encoder.layers.0.ffn.fc1.weight"]
    s = scales["encoder.layers.0.ffn.fc1.weight"]
    assert torch.equal(enc["layers.0.ffn.fc1.weight"],
                       w.to(torch.bfloat16) * s[:, None].to(torch.bfloat16))
    dec = model.decoder
    assert isinstance(dec.embed, Int8Embedding)
    linears = [m for m in dec.modules() if isinstance(m, Int8Linear)]
    per_layer = 2 + 4 + 2 if not cfg.model.fused_qkv else 1 + 4 + 2 + 1
    assert len(linears) == cfg.model.num_decoder_layers * per_layer
    for m in linears:
        assert m.weight_q.dtype == torch.int8 and m.scale.dtype == torch.float32
        assert m.bias.dtype == torch.bfloat16
    assert not any(isinstance(m, torch.nn.Linear) for m in dec.modules())
    assert dec.final_norm.weight.dtype == torch.bfloat16
