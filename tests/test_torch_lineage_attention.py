"""Port lineage self-attention against the JAX package's Pallas kernel
(interpret mode) and its jnp reference, on the cases of
tests/test_lineage_attention_kernel.py: float32 at 2e-6 (accumulation
order only) and a bfloat16 cache at 2e-2 (weights rounded to bf16 before
the AV product). The port's CUDA kernel is held against the same plain
version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.kernels.lineage_attention import (  # noqa: E402
    lineage_attention, lineage_attention_reference as jax_reference)
from speech_tranformer_pytorch_tpu_torch.kernels import interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels.lineage_attention import (  # noqa: E402
    lineage_attention_cuda, lineage_attention_reference)


def _inputs(seed, b, k, L, h, d, index, lineage=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b * k, 1, h, d)).astype(np.float32)
    ck = rng.standard_normal((b * k, L, h, d)).astype(np.float32)
    cv = rng.standard_normal((b * k, L, h, d)).astype(np.float32)
    if lineage is None:
        # Valid table: identity at j >= index, arbitrary ancestors before.
        lineage = rng.integers(0, k, size=(b, k, L)).astype(np.int32)
        lineage[:, :, index:] = np.arange(k, dtype=np.int32)[None, :, None]
    return q, ck, cv, lineage


def _shared_history(b, k, L, index):
    """Every beam shares beam 0's history (a common post-prune state)."""
    lin = np.zeros((b, k, L), np.int32)
    lin[:, :, index + 1:] = np.arange(k, dtype=np.int32)[None, :, None]
    return lin


CASES = [
    # name, (b, k, L, h, d, index), dtype, atol, lineage
    ("beam5_base_shapes", (3, 5, 40, 4, 64, 17), "float32", 2e-6, None),
    ("step0_identity", (2, 4, 16, 2, 32, 0), "float32", 2e-6, None),
    ("last_position", (2, 3, 24, 2, 64, 23), "float32", 2e-6, None),
    ("greedy_width1", (4, 1, 20, 4, 64, 9), "float32", 2e-6, None),
    ("bf16_cache", (2, 5, 32, 4, 64, 21), "bfloat16", 2e-2, None),
    ("cross_beam_ancestry", (1, 3, 12, 2, 32, 7), "float32", 2e-6,
     _shared_history(1, 3, 12, 7)),
    # A cache longer than the base preset's 100 positions, and a beam-5
    # shared history in bf16 (the chip_smoke.py cases at tiny widths).
    ("long_cache", (1, 5, 256, 2, 32, 200), "float32", 2e-6, None),
    ("bf16_shared_history", (2, 5, 32, 2, 64, 20), "bfloat16", 2e-2,
     _shared_history(2, 5, 32, 20)),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_matches_jax_kernel_and_reference(case):
    _, (b, k, L, h, d, index), dtype, atol, lin = case
    q, ck, cv, lin = _inputs(0, b, k, L, h, d, index, lin)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(x, jdt) for x in (q, ck, cv)]
    want_kernel = lineage_attention(*jargs, jnp.asarray(lin), jnp.int32(index), k,
                                    interpret=True)
    want_ref = jax_reference(*jargs, jnp.asarray(lin), jnp.int32(index), k)
    targs = [torch.from_numpy(x).to(tdt) for x in (q, ck, cv)]
    got = lineage_attention_reference(*targs, torch.from_numpy(lin),
                                      torch.tensor(index, dtype=torch.int32), k)
    assert got.shape == (b * k, 1, h, d) and got.dtype == tdt
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=atol, rtol=1e-5)


def test_interface_uses_plain_path_on_cpu():
    q, ck, cv, lin = _inputs(1, 2, 3, 10, 2, 32, 4)
    args = [torch.from_numpy(x) for x in (q, ck, cv, lin)]
    index = torch.tensor(4, dtype=torch.int32)
    before = dict(interface.launch_counts())
    got = interface.lineage_attention(*args, index, 3)
    assert interface.launch_counts() == before
    torch.testing.assert_close(got, lineage_attention_reference(*args, index, 3),
                               rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensor():
    q, ck, cv, lin = _inputs(2, 1, 2, 8, 2, 32, 3)
    with pytest.raises(ValueError, match="CUDA"):
        lineage_attention_cuda(*(torch.from_numpy(x) for x in (q, ck, cv, lin)),
                               torch.tensor(3, dtype=torch.int32), 2)
