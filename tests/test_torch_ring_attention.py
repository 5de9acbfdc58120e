"""The port's ring attention and its flash stats route against the JAX
package's ``parallel/ring_attention.py`` and ``flash_block_stats``.

- ``FlashAttentionStats`` (the ring's per-block body: B-4 forward, B-5/B-6
  backward with di − dlse; here through the kernels' plain versions) and
  its plain route ``interface.flash_attention_stats`` against JAX
  ``flash_block_stats`` in interpret mode: o, lse, and the gradients of
  both under a nonzero lse cotangent, a row with no kept key included
  (f32, 1e-5).
- ``ring_attention`` on 4 gloo ranks, flash and dot bodies, against JAX's
  ``ring_attention`` on a 4-way model axis of the fake 8-device mesh:
  output and gradients, with one row whose last two key blocks are empty
  (JAX's ring tolerance, 2e-4). ``ring_self_attention`` from head-sharded
  inputs (all_to_all to frames and back, a frame count the ring does not
  divide) against JAX's the same way.

The ranks are spawned once for the module (``parallel.mesh.spawn_ranks``);
their code imports nothing of JAX: JAX is imported inside the fixtures."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu_torch.kernels import interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttentionStats)
from speech_tranformer_pytorch_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, spawn_ranks)
from speech_tranformer_pytorch_tpu_torch.parallel.ring_attention import (  # noqa: E402
    ring_attention, ring_self_attention)

F32 = dict(rtol=1e-5, atol=1e-5)
RING = dict(rtol=2e-4, atol=2e-4)
N = 4                          # ring size
B, T, H, D = 3, 32, 4, 8       # T/N = 8-frame blocks
LENS = [32, 13, 20]            # row 1: blocks 2 and 3 hold no key
T_SELF = 30                    # not a multiple of N: ring_self_attention pads


def _arrays(seed, t):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, t, H, D)).astype(np.float32) for _ in range(4)]


# ------------------------------------------------------------ flash stats

@pytest.fixture(scope="module")
def stats_case():
    import jax
    import jax.numpy as jnp

    from speech_tranformer_pytorch_tpu.kernels.flash_attention import flash_block_stats

    rng = np.random.default_rng(5)
    b, h, t, s, d = 2, 2, 24, 19, 16
    q, do = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(2))
    dlse = rng.standard_normal((b, h, t)).astype(np.float32)
    lens = np.array([19, 0], np.int32)               # row 1 keeps no key

    def loss(q_, k_, v_):
        o, lse = flash_block_stats(q_, k_, v_, jnp.asarray(lens))
        lse = lse[:, :, :t, 0]
        return jnp.sum(o * do) + jnp.sum(lse * dlse), (o, lse)

    (_, (o, lse)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(jnp.asarray(q), jnp.asarray(k),
                                                 jnp.asarray(v))
    want = [np.asarray(x) for x in (o, lse) + tuple(grads)]
    return dict(q=q, k=k, v=v, do=do, dlse=dlse, lens=lens, want=want)


@pytest.mark.parametrize("route", ["autograd_function", "plain"])
def test_flash_stats_match_jax(stats_case, route):
    c = stats_case
    q, k, v = (torch.from_numpy(c[x]).requires_grad_() for x in "qkv")
    lens = torch.from_numpy(c["lens"])
    if route == "autograd_function":
        o, lse = FlashAttentionStats.apply(q, k, v, lens, False)
    else:
        o, lse = interface.flash_attention_stats(q, k, v, lens)
    ((o * torch.from_numpy(c["do"])).sum() + (lse * torch.from_numpy(c["dlse"])).sum()
     ).backward()
    got = [o.detach(), lse.detach(), q.grad, k.grad, v.grad]
    for name, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, c["want"]):
        if name == "lse":      # the empty row: both near MASK_VALUE, finite
            np.testing.assert_allclose(g[0].numpy(), w[0], **F32)
            assert np.isfinite(g.numpy()).all() and (g[1] < -1e38).all()
            continue
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **F32)
    assert not got[0][1].any() and not got[2][1].any()   # o = 0, no gradient


# --------------------------------------------------------------- the ring

def _ring_rank(rank, inputs):
    """One rank of a 4-way ring (mesh (1, 4)): its frame block of each
    body's output and gradients, and its heads of ring_self_attention."""
    torch.set_num_threads(1)
    mesh = make_mesh(model_axis_size=N, device="cpu")
    lens = torch.tensor(LENS, dtype=torch.int32)
    out = {}
    blk = slice(rank * (T // N), (rank + 1) * (T // N))
    q, k, v, do = (torch.from_numpy(x[:, blk]).clone().requires_grad_() for x in
                   inputs["ring"])
    for body in ("flash", "dot"):
        o = ring_attention(q, k, v, lens, mesh, body=body)
        grads = torch.autograd.grad((o * do).sum(), (q, k, v))
        out[body] = [o.detach()] + list(grads)
    heads = slice(rank * (H // N), (rank + 1) * (H // N))
    q, k, v, do = (torch.from_numpy(x[:, :, heads]).clone().requires_grad_() for x in
                   inputs["self"])
    o = ring_self_attention(q, k, v, lens.clamp(max=T_SELF), mesh)
    out["self"] = [o.detach()] + list(torch.autograd.grad((o * do).sum(), (q, k, v)))
    return out


@pytest.fixture(scope="module")
def ring_case():
    import jax
    import jax.numpy as jnp

    from speech_tranformer_pytorch_tpu.parallel import make_mesh as jax_mesh
    from speech_tranformer_pytorch_tpu.parallel import (
        ring_attention as jax_ring, ring_self_attention as jax_ring_self)

    inputs = {"ring": _arrays(1, T), "self": _arrays(2, T_SELF)}
    ranks = spawn_ranks(_ring_rank, N, inputs)
    mesh = jax_mesh(model_axis_size=N)
    lens = jnp.asarray(LENS, jnp.int32)

    def jax_run(fn, arrays):
        q, k, v, do = (jnp.asarray(x) for x in arrays)

        def loss(*a):
            o = fn(*a)
            return jnp.sum(o * do), o

        (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                   has_aux=True))(q, k, v)
        return [np.asarray(o)] + [np.asarray(g) for g in grads]

    want = {body: jax_run(lambda q, k, v, b=body: jax_ring(q, k, v, lens, mesh, body=b),
                          inputs["ring"]) for body in ("flash", "dot")}
    want["self"] = jax_run(lambda q, k, v: jax_ring_self(
        q, k, v, jnp.minimum(lens, T_SELF), mesh), inputs["self"])
    return ranks, want


@pytest.mark.parametrize("body", ["flash", "dot"])
def test_ring_matches_jax(ring_case, body):
    ranks, want = ring_case
    got = [torch.cat([r[body][i] for r in ranks], dim=1).numpy() for i in range(4)]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want[body]):
        np.testing.assert_allclose(g, w, err_msg=name, **RING)
        assert np.isfinite(g).all()


def test_ring_self_attention_from_head_shards_matches_jax(ring_case):
    ranks, want = ring_case
    got = [torch.cat([r["self"][i] for r in ranks], dim=2).numpy() for i in range(4)]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want["self"]):
        np.testing.assert_allclose(g, w, err_msg=name, **RING)


def test_ring_equals_full_flash_attention(ring_case):
    """The ring's flash body is the whole-sequence flash function."""
    ranks, _ = ring_case
    q, k, v, _ = (torch.from_numpy(x) for x in _arrays(1, T))
    full = interface.flash_attention(q, k, v, kv_lengths=torch.tensor(LENS),
                                     causal=False)
    ring = torch.cat([r["flash"][0] for r in ranks], dim=1)
    np.testing.assert_allclose(ring.numpy(), full.numpy(), **RING)
