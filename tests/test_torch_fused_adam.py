"""Port fused Adam against the JAX package: ``FusedAdam(impl="pallas")``
(its Pallas kernel in interpret mode) and the optax chain of
``make_optimizer``, over the clip and weight-decay cases of
tests/test_ops.py, with float32 and bfloat16 moments, for 4 steps from the
same tree. float32: params and moments at test_ops' rtol 1e-6, atol 1e-7.
bfloat16 moments: the f32 update math may round a moment to the
neighbouring bf16 value, so moments agree within one bf16 ulp and params
within 1e-6. The port's kernel is held to the same plain version on the
card by chip_smoke.py, where the two agree bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.ops.fused_adam import FusedAdam as JaxFusedAdam  # noqa: E402
from speech_tranformer_pytorch_tpu.ops.schedules import (  # noqa: E402
    make_optimizer, noam_schedule as jax_noam)
from speech_tranformer_pytorch_tpu_torch.kernels.fused_adam import (  # noqa: E402
    fused_adam_cuda, fused_adam_master_cuda)
from speech_tranformer_pytorch_tpu_torch.ops.fused_adam import (  # noqa: E402
    FusedAdam, global_norm_f32)
from speech_tranformer_pytorch_tpu_torch.ops.schedules import noam_schedule  # noqa: E402

HYPER = dict(b1=0.9, b2=0.98, eps=1e-9)


def _trees():
    """test_ops' tree and grads (1-D grads large enough to trigger the clip)."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((37, 129)).astype(np.float32),
              "b": rng.standard_normal((129,)).astype(np.float32),
              "nested": {"e": rng.standard_normal((300,)).astype(np.float32)}}
    grads = jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * (10.0 if x.ndim == 1 else 0.1)
                   ).astype(np.float32), params)
    return params, grads


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(x, np.float32)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bf16_ulp(x):
    _, e = np.frexp(np.maximum(np.abs(x), np.finfo(np.float32).tiny))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip,wd", [(5.0, 0.0), (0.05, 0.0), (5.0, 0.01), (0.0, 0.0)])
def test_matches_jax_fused_and_optax(clip, wd, moment_dtype):
    params, grads = _trees()
    jfused = JaxFusedAdam(jax_noam(64, 100, 1.0), grad_clip_norm=clip, weight_decay=wd,
                          impl="pallas", moment_dtype=moment_dtype, **HYPER)
    tx = make_optimizer(64, 100, scale=1.0, grad_clip_norm=clip, weight_decay=wd,
                        moment_dtype=moment_dtype, **HYPER)
    jp = op = jax.tree.map(jnp.asarray, params)
    jstate, ostate = jfused.init(jp), tx.init(op)
    jstep = jax.jit(jfused.update_apply)

    opt = FusedAdam(noam_schedule(64, 100, 1.0), grad_clip_norm=clip, weight_decay=wd,
                    moment_dtype=moment_dtype, **HYPER)
    pp = {k: torch.from_numpy(v.copy()) for k, v in _flat(params).items()}
    pstate = opt.init(pp)
    for step in range(4):
        g = jax.tree.map(lambda x: x * (0.5 ** step), grads)
        jp, jstate = jstep(g, jstate, jp)
        updates, ostate = tx.update(g, ostate, op)
        op = jax.tree.map(lambda a, u: a + u, op, updates)
        pstate = opt.update_apply({k: torch.from_numpy(v) for k, v in _flat(g).items()},
                                  pstate, pp)
        assert int(pstate.count) == step + 1
        for want in (_flat(jp), _flat(op)):
            for k, v in want.items():
                tol = dict(rtol=1e-6, atol=1e-7 if moment_dtype == "float32" else 1e-6)
                np.testing.assert_allclose(pp[k].numpy(), v, err_msg=k, **tol)
        for mine, theirs in ((pstate.mu, jstate.mu), (pstate.nu, jstate.nu)):
            for k, v in _flat(theirs).items():
                got = mine[k].float().numpy()
                if moment_dtype == "float32":
                    np.testing.assert_allclose(got, v, rtol=1e-6, atol=1e-7, err_msg=k)
                else:
                    assert mine[k].dtype == torch.bfloat16
                    assert (np.abs(got - v) <= _bf16_ulp(v)).all(), k


def test_global_norm_and_dispatch():
    g = [torch.full((3,), 2.0), torch.full((4, 4), 1.0)]
    assert float(global_norm_f32(g)) == pytest.approx(np.sqrt(12.0 + 16.0))
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam_cuda([g[0]], [g[0]], [g[0]], [g[0]], torch.zeros(4), b1=0.9,
                        b2=0.98, eps=1e-9, weight_decay=0.0)
    # master_weights is ported: the update needs the state's f32 master, and
    # the master variant's wrapper, like the classic one, needs the card.
    opt = FusedAdam(noam_schedule(64, 100), master_weights=True)
    state = FusedAdam(noam_schedule(64, 100)).init({"w": g[0]})
    with pytest.raises(ValueError, match="master"):
        opt.update_apply({"w": g[0]}, state, {"w": g[0].to(torch.bfloat16)})
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam_master_cuda([g[0].bfloat16()], [g[0].bfloat16()], [g[0]], [g[0]],
                               [g[0]], torch.zeros(4), b1=0.9, b2=0.98, eps=1e-9,
                               weight_decay=0.0)
