"""Port lineage self-attention against the JAX package's Pallas kernel
(interpret mode) and its jnp reference, on the cases of
tests/test_lineage_attention_kernel.py: float32 at 2e-6 (accumulation
order only) and a bfloat16 cache at 2e-2 (weights rounded to bf16 before
the AV product). The port's CUDA kernel is held against the same plain
version on the card by chip_smoke.py. The decode step's write-and-attend
form (``interface.lineage_attention_step``): its plain version against
``index_copy_`` and the plain attention, bit for bit, on the fused qkv
projection's strided views and on separate tensors, and what its kernel
wrapper refuses."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.kernels.lineage_attention import (  # noqa: E402
    lineage_attention, lineage_attention_reference as jax_reference)
from speech_tranformer_pytorch_tpu_torch.kernels import interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels.lineage_attention import (  # noqa: E402
    lineage_attention_cuda, lineage_attention_reference, lineage_attention_step_cuda)


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


# The write-and-attend form (the decode step's): q, k_new and v_new come as
# the fused qkv projection's strided views or as separate tensors; the plain
# version is index_copy_ of both rows, then the plain attention.
STEP_L, STEP_B, STEP_H, STEP_D = 12, 2, 2, 16


def _step_inputs(seed, k, index, layout, dtype):
    g = torch.Generator().manual_seed(seed)
    bk, h, d = STEP_B * k, STEP_H, STEP_D
    if layout == "fused_qkv_views":   # unbind views of one [B·K, 1, 3·H·D] output
        qkv = torch.randn(bk, 1, 3 * h * d, generator=g).to(dtype)
        q, kn, vn = qkv.unflatten(-1, (3, h, d)).unbind(-3)
        assert q.stride(0) == 3 * h * d and not q.is_contiguous()
    else:
        q, kn, vn = (torch.randn(bk, 1, h, d, generator=g).to(dtype) for _ in range(3))
    ck, cv = (torch.randn(bk, STEP_L, h, d, generator=g).to(dtype) for _ in range(2))
    lin = torch.randint(0, k, (STEP_B, k, STEP_L), generator=g, dtype=torch.int32)
    lin[:, :, index:] = torch.arange(k, dtype=torch.int32)[None, :, None]
    return q, kn, vn, ck, cv, lin


@pytest.mark.parametrize("index", [0, 5, STEP_L - 1])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["fused_qkv_views", "separate_contiguous"])
def test_step_plain_version_writes_the_rows_then_attends(layout, dtype, k, index):
    q, kn, vn, ck, cv, lin = _step_inputs(7, k, index, layout, getattr(torch, dtype))
    step = torch.tensor(index, dtype=torch.int32)
    want_k, want_v = ck.clone(), cv.clone()
    pos = torch.tensor([index])
    want_k.index_copy_(1, pos, kn)
    want_v.index_copy_(1, pos, vn)
    want = lineage_attention_reference(q, want_k, want_v, lin, step, k)
    got_k, got_v = ck.clone(), cv.clone()
    before = interface.row_write_counts()
    got = interface.lineage_attention_step(q, kn, vn, got_k, got_v, lin, step, k)
    after = interface.row_write_counts()
    assert after == {**before, "index_copy": before["index_copy"] + 1}
    assert got.is_contiguous() and got.dtype == q.dtype
    assert torch.equal(got, want)
    assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v)
    # Row (lane, index) holds the new rows; every other row is untouched.
    assert torch.equal(got_k[:, index], kn[:, 0]) and torch.equal(got_v[:, index], vn[:, 0])
    others = torch.arange(STEP_L) != index
    assert torch.equal(got_k[:, others], ck[:, others])
    assert torch.equal(got_v[:, others], cv[:, others])


def _refusal_cases():
    def wrong_k_shape(a):
        a["k_new"] = a["k_new"][:, :, :1]
    def wrong_v_dtype(a):
        a["v_new"] = a["v_new"].double()
    def heads_not_d_apart(a):
        a["q_new"] = a["q_new"].transpose(2, 3).contiguous().transpose(2, 3)
    def cpu_tensors(a):
        pass
    return [("wrong_k_new_shape", wrong_k_shape, "k_new"),
            ("wrong_v_new_dtype", wrong_v_dtype, "v_new"),
            ("q_heads_not_d_apart", heads_not_d_apart, "heads must lie D apart"),
            ("cpu_tensors", cpu_tensors, "CUDA")]


@pytest.mark.parametrize("case", _refusal_cases(), ids=lambda c: c[0])
def test_step_kernel_wrapper_refuses(case):
    _, spoil, match = case
    q, kn, vn, ck, cv, lin = _step_inputs(3, 5, 4, "fused_qkv_views", torch.float32)
    args = dict(q_new=q, k_new=kn, v_new=vn, self_k=ck, self_v=cv, lineage=lin)
    spoil(args)
    with pytest.raises(ValueError, match=match):
        lineage_attention_step_cuda(**args, index=torch.tensor(4, dtype=torch.int32),
                                    beam_width=5)
