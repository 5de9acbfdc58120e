"""Port flash attention against the JAX package's ``mha_flash`` (its Pallas
kernels in interpret mode, forward and ``jax.grad``) on ragged, causal,
zero-length and non-tile-multiple shapes, and the port's
``FlashAttention`` autograd Function (the recompute backward, here through
the plain versions of the three kernels) against torch autograd of the
plain path. float32 at 1e-5 (summation order and online-softmax rescaling
only); bfloat16 at the JAX goldens' 2e-2. The CUDA kernels are held to the
same plain versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.kernels.flash_attention import mha_flash  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels import interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels.flash_attention import (  # noqa: E402
    MASK_VALUE, FlashAttention, _aligned_operands, flash_attention_reference,
    flash_fwd_cuda, flash_fwd_reference)

F32 = dict(rtol=1e-5, atol=1e-5)

CASES = [
    # name, (b, t, s, h, d), kv lengths, causal
    ("ragged", (3, 40, 53, 2, 32), [53, 20, 1], False),
    ("causal_ragged", (2, 37, 37, 2, 32), [37, 15], True),
    ("zero_length", (2, 24, 24, 1, 16), [24, 0], False),
    ("non_tile_multiple", (2, 70, 67, 2, 64), [67, 33], False),
    ("wide_head", (2, 24, 24, 2, 128), [24, 13], False),     # the sharded preset's D
    ("causal_long", (2, 200, 200, 1, 16), [200, 131], True),  # > three 64-row tiles
]


def _inputs(seed, b, t, s, h, d):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal(shape).astype(np.float32)
                  for shape in ((b, t, h, d), (b, s, h, d), (b, s, h, d), (b, t, h, d)))
    return q, k, v, w


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    name, (b, t, s, h, d), lens, causal = request.param
    q, k, v, w = _inputs(len(name), b, t, s, h, d)
    lens = np.asarray(lens, np.int32)

    def loss(q_, k_, v_):
        o = mha_flash(q_, k_, v_, kv_lengths=jnp.asarray(lens), causal=causal)
        return jnp.sum(o * o * w), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in (o,) + tuple(grads)]
    return dict(q=q, k=k, v=v, w=w, lens=lens, causal=causal, want=want)


def _port(c):
    q, k, v = (torch.from_numpy(c[x]).requires_grad_() for x in "qkv")
    o = interface.flash_attention(q, k, v, kv_lengths=torch.from_numpy(c["lens"]),
                                  causal=c["causal"])
    (o * o * torch.from_numpy(c["w"])).sum().backward()
    return [o.detach().numpy()] + [x.grad.numpy() for x in (q, k, v)]


def test_forward_and_grads_match_jax(case):
    got = _port(case)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, case["want"]):
        np.testing.assert_allclose(g, w, err_msg=name, **F32)
    for b, n in enumerate(case["lens"]):
        if n == 0:   # no kept key: o = 0 and zero, finite gradients
            assert not got[0][b].any() and not got[1][b].any()


def test_autograd_function_matches_plain_autograd(case):
    """FlashAttention.apply (forward with lse, backward = di in torch +
    the dK/dV and dQ plain versions) against autograd of the plain path."""
    lens = torch.from_numpy(case["lens"])
    w = torch.from_numpy(case["w"]).transpose(1, 2)
    out = []
    for fn in (lambda q, k, v: FlashAttention.apply(q, k, v, lens, case["causal"]),
               lambda q, k, v: flash_attention_reference(q, k, v, lens,
                                                         causal=case["causal"])):
        q, k, v = (torch.from_numpy(case[x]).transpose(1, 2).requires_grad_()
                   for x in "qkv")
        o = fn(q, k, v)
        (o * o * w).sum().backward()
        out.append([o.detach()] + [x.grad for x in (q, k, v)])
    for name, a, b in zip(("o", "dq", "dk", "dv"), *out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **F32)


def test_lse_and_zero_rows():
    q, k, v, _ = (torch.from_numpy(x).transpose(1, 2) for x in _inputs(1, 2, 9, 9, 1, 8))
    lens = torch.tensor([9, 0], dtype=torch.int32)
    o, lse = flash_fwd_reference(q, k, v, lens, causal=False)
    s = torch.einsum("bhtd,bhsd->bhts", q, k) / np.sqrt(8)
    torch.testing.assert_close(lse[0], torch.logsumexp(s[0], -1))
    assert torch.isfinite(lse).all() and not o[1].any()
    assert float(lse[1].max()) == pytest.approx(MASK_VALUE + np.log(1e-37), rel=1e-6)


def test_bf16_matches_jax():
    q, k, v, _ = _inputs(7, 2, 33, 40, 2, 32)
    lens = np.array([40, 17], np.int32)
    want = mha_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                     kv_lengths=jnp.asarray(lens))
    got = interface.flash_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        kv_lengths=torch.from_numpy(lens), causal=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [False, True], ids=["ragged", "causal"])
def test_bf16_grads_match_jax(causal):
    """bf16 dq, dk and dv of the port's plain path (``FlashAttention`` over
    the plain versions of the three kernels, the functions the kernels are
    held to on the card) against ``jax.grad`` of ``mha_flash``, within 2e-2
    of each tensor's largest value."""
    q, k, v, w = _inputs(11, 2, 70, 70, 2, 32)
    lens = np.array([70, 23], np.int32)

    def loss(q_, k_, v_):
        o = mha_flash(q_, k_, v_, kv_lengths=jnp.asarray(lens), causal=causal)
        return jnp.sum(o.astype(jnp.float32) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    o = FlashAttention.apply(qt, kt, vt, torch.from_numpy(lens), causal)
    (o.float() * torch.from_numpy(w).transpose(1, 2)).sum().backward()
    for name, got, ref in zip(("dq", "dk", "dv"), (qt, kt, vt), want):
        assert got.grad.dtype == torch.bfloat16
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.grad.transpose(1, 2).float().numpy(), ref,
                                   rtol=0, atol=2e-2 * np.abs(ref).max(), err_msg=name)


def test_bwd_operands_copy_only_what_the_kernels_cannot_read():
    """The bf16 backward kernels copy rows in 16-byte chunks: aligned views
    (those of a fused QKV projection too) go in as they are; D not a
    multiple of 8 or a stride off the 16-byte grid gets an aligned copy,
    zero-padded to a multiple of 8 columns; f32 inputs are never copied."""
    qkv = torch.randn(2, 5, 3, 4, 64, dtype=torch.bfloat16)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    do = torch.randn(2, 5, 4, 64, dtype=torch.bfloat16).transpose(1, 2)
    out = _aligned_operands(q, k, v, do)
    assert all(a is b for a, b in zip(out, (q, k, v, do)))
    narrow = torch.randn(2, 5, 4, 20, dtype=torch.bfloat16).transpose(1, 2)
    strided = torch.randn(2, 5, 4, 65, dtype=torch.bfloat16)[..., :64].transpose(1, 2)
    for x, d8 in ((narrow, 24), (strided, 64)):
        got = _aligned_operands(x, x, x, x)
        assert len(got) == 4 and all(g.shape == x.shape[:3] + (d8,) for g in got)
        for g in got:
            assert g.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in g.stride()[:3])
            assert torch.equal(g[..., :x.shape[-1]], x) and not g[..., x.shape[-1]:].any()
    f = narrow.float()
    assert _aligned_operands(f, f, f, f)[0] is f


def test_aligned_operands_for_the_forward():
    """The forward kernel reads q, k and v as the backward kernels do: the
    same helper leaves aligned views (k and v longer than q) as they are and
    copies a misaligned one alone, keeping its length."""
    q = torch.randn(2, 5, 4, 64, dtype=torch.bfloat16).transpose(1, 2)
    kv = torch.randn(2, 9, 2, 4, 64, dtype=torch.bfloat16)
    k, v = (x.transpose(1, 2) for x in kv.unbind(2))
    got = _aligned_operands(q, k, v)
    assert all(a is b for a, b in zip(got, (q, k, v)))
    odd = torch.randn(2, 9, 4, 72, dtype=torch.bfloat16)[..., 4:68].transpose(1, 2)
    gq, gk, gv = _aligned_operands(q, odd, v)
    assert gq is q and gv is v and gk.shape == odd.shape and torch.equal(gk, odd)
    assert gk.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in gk.stride()[:3])
    narrow = torch.randn(2, 5, 4, 20, dtype=torch.bfloat16).transpose(1, 2)
    got = _aligned_operands(narrow, narrow[:, :, :3], narrow)
    assert [tuple(g.shape) for g in got] == [(2, 4, 5, 24), (2, 4, 3, 24), (2, 4, 5, 24)]


def test_dispatch_rules(monkeypatch):
    from speech_tranformer_pytorch_tpu_torch.kernels import flash_attention as flash

    q = torch.zeros(1, 4, 1, 8)
    # Attention dropout, while training, routes to the dot-product core (as
    # JAX routes it): the flash path's plain version is not called.
    calls = []
    real = flash.flash_attention_reference
    monkeypatch.setattr(flash, "flash_attention_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = interface.flash_attention(q, q, q, kv_lengths=torch.tensor([4]), causal=False,
                                    dropout_rate=0.1, deterministic=False)
    assert calls == [] and out.shape == q.shape
    interface.flash_attention(q, q, q, kv_lengths=torch.tensor([4]), causal=False,
                              dropout_rate=0.1, deterministic=True)
    assert calls == [1]
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_cuda(q, q, q, torch.tensor([4]), causal=False)
