"""The int8 kernels' plain versions and the int8 modules against the JAX
package (CPU).

``int8_matmul_reference`` and ``int8_ffn_reference`` are held to JAX's
``int8_matmul_reference`` / ``int8_ffn_reference`` and to its Pallas
kernels in interpret mode (bf16 activations: the TPU kernels always run
bf16 operands). Tolerances: f32 outputs within 1e-5 of each row's largest
value (only the summation order differs); bf16 outputs of the matmul
within one bf16 ulp (one rounding of the same f32 value) plus that 1e-5
of the row's largest value (outputs near 0 come from cancelling sums);
bf16 outputs of
the feed-forward within 1e-3 of the row's largest value, JAX's own bound
for its kernel (``tests/test_int8_dense.py``), since the hidden layer is
rounded to bf16 after a differently ordered sum, plus one bf16 ulp for
the port's output in the activation dtype (JAX's reference returns f32,
its modules then round it). ``Int8Linear`` and the
int8 ``FeedForward`` are held to JAX's ``QuantDenseGeneral`` and
``FeedForward`` with ``ST_TPU_INT8_MIN_WEIGHT_BYTES=0``, the kernel-math
branch the port takes at every size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.kernels.int8_ffn import (  # noqa: E402
    int8_ffn as jax_int8_ffn_kernel, int8_ffn_reference as jax_int8_ffn)
from speech_tranformer_pytorch_tpu.kernels.int8_matmul import (  # noqa: E402
    int8_matmul as jax_int8_matmul_kernel, int8_matmul_reference as jax_int8_matmul)
from speech_tranformer_pytorch_tpu.models.modules import (  # noqa: E402
    FeedForward as JaxFeedForward, QuantDenseGeneral)
from speech_tranformer_pytorch_tpu_torch.kernels import interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels.int8_ffn import int8_ffn_reference  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels.int8_matmul import (  # noqa: E402
    int8_matmul_reference)
from speech_tranformer_pytorch_tpu_torch.models.modules import (  # noqa: E402
    FeedForward, Int8Linear)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def kernel_threshold_0(monkeypatch):
    monkeypatch.setenv("ST_TPU_INT8_MIN_WEIGHT_BYTES", "0")


def _t(x, dtype=None):
    x = np.asarray(jnp.asarray(x, jnp.float32))
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _matmul_case(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(0.001, 0.02, n).astype(np.float32)
    return x, wq, scale


def _row_rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-30)
    return float((np.abs(got - want) / scale).max())


def _bf16_ulp(x):
    x = np.maximum(np.abs(np.asarray(x, np.float64)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


MATMUL_SHAPES = [(16, 128, 256), (80, 512, 1536), (160, 2048, 512), (7, 96, 200)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_int8_matmul_plain_matches_jax(m, k, n, dtype):
    jdt, tdt = DTYPES[dtype]
    x, wq, scale = _matmul_case(m, k, n)
    xj = jnp.asarray(x).astype(jdt)
    want = np.asarray(jax_int8_matmul(xj, jnp.asarray(wq), jnp.asarray(scale)))
    before = dict(interface.launch_counts())
    got = interface.int8_dense(_t(xj, tdt), torch.from_numpy(wq), torch.from_numpy(scale))
    assert interface.launch_counts() == before
    assert got.dtype == tdt and got.shape == (m, n)
    got = got.float().numpy()
    if dtype == "float32":
        assert _row_rel_err(got, want) < 1e-5
    else:
        refs = [want]
        if n % 128 == 0:   # the TPU kernel's own math (bf16 operands), interpreted
            refs.append(np.asarray(jax_int8_matmul_kernel(
                xj, jnp.asarray(wq), jnp.asarray(scale),
                block_n=min(n, 512) if n % 512 == 0 else 128, interpret=True)))
        for ref in refs:
            rowmax = np.abs(ref).max(axis=1, keepdims=True)
            assert bool((np.abs(got - ref) <= _bf16_ulp(ref) + 1e-5 * rowmax).all())


def _ffn_case(m, k, ff, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w1 = rng.integers(-127, 128, (k, ff)).astype(np.int8)
    s1 = rng.uniform(0.001, 0.02, ff).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(ff)).astype(np.float32)
    w2 = rng.integers(-127, 128, (ff, n)).astype(np.int8)
    s2 = rng.uniform(0.001, 0.02, n).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, w1, s1, b1, w2, s2, b2


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,ff,n,block_ff", [(16, 128, 256, 128, 128),
                                               (48, 512, 2048, 512, 512),
                                               (7, 96, 200, 72, None)])
def test_int8_ffn_plain_matches_jax(m, k, ff, n, block_ff, dtype):
    jdt, tdt = DTYPES[dtype]
    x, *w = _ffn_case(m, k, ff, n)
    xj = jnp.asarray(x).astype(jdt)
    wj = [jnp.asarray(a) for a in w]
    want = np.asarray(jax_int8_ffn(xj, *wj))
    got = interface.int8_ffn(_t(xj, tdt), *[torch.from_numpy(a) for a in w])
    assert got.dtype == tdt and got.shape == (m, n)
    got = got.float().numpy()
    if dtype == "float32":
        assert _row_rel_err(got, want) < 1e-5
        return
    refs = [want]
    if block_ff is not None:
        refs.append(np.asarray(jax_int8_ffn_kernel(xj, *wj, block_ff=block_ff,
                                                   interpret=True)))
    for ref in refs:   # JAX's f32 bound, plus the output's rounding to bf16
        bound = 1e-3 * np.abs(ref).max(axis=1, keepdims=True) + _bf16_ulp(ref)
        assert bool((np.abs(got - ref) <= bound).all())


def _quantize_kernel(w):
    s = jnp.max(jnp.abs(w), axis=tuple(range(w.ndim - 1)), keepdims=True) / 127.0
    return jnp.clip(jnp.round(w / s), -127, 127).astype(jnp.int8), s


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [
    dict(name="qkv", features=(3, 4, 64), axis=-1, in_shape=(6, 1, 256)),
    dict(name="q", features=(4, 64), axis=-1, in_shape=(2, 5, 256)),
    dict(name="out", features=256, axis=(-2, -1), in_shape=(6, 1, 4, 64)),
])
def test_int8_linear_matches_quant_dense_general(kernel_threshold_0, case, dtype):
    jdt, tdt = DTYPES[dtype]
    mod = QuantDenseGeneral(case["features"], axis=case["axis"], dtype=jdt)
    x = jax.random.normal(jax.random.PRNGKey(7), case["in_shape"]).astype(jdt)
    v = mod.init(jax.random.PRNGKey(3), x)
    kern = v["params"]["kernel"]
    kern = kern * (1.0 + 0.5 * jnp.cos(jnp.arange(kern.shape[-1])))
    bias = 0.1 * jax.random.normal(jax.random.PRNGKey(4), v["params"]["bias"].shape)
    wq, s = _quantize_kernel(kern)
    want = mod.apply({"params": {"kernel": wq, "bias": bias.astype(jdt)},
                      "qscales": {"kernel": s}}, x)
    n_in = len(case["in_shape"]) - (2 if case["name"] == "out" else 1)
    k = int(np.prod(case["in_shape"][n_in:]))
    n = int(np.prod(np.atleast_1d(case["features"])))
    cols = np.array(jnp.broadcast_to(s, kern.shape).reshape(k, n)[0])
    lin = Int8Linear(torch.from_numpy(np.asarray(wq).reshape(k, n).T.copy()),
                     torch.from_numpy(cols), _t(bias.reshape(n)), tdt)
    xt = _t(x, tdt)
    got = lin(xt.flatten(-2) if case["name"] == "out" else xt)
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32)).reshape(got.shape)
    got = got.float().numpy()
    if dtype == "float32":
        assert _row_rel_err(got.reshape(-1, n), want.reshape(-1, n)) < 1e-5
    else:   # one rounding to bf16, then the bias added in bf16: two ulps
        assert bool((np.abs(got - want) <= 2 * _bf16_ulp(want)).all())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_feed_forward_matches_jax(kernel_threshold_0, dtype):
    jdt, tdt = DTYPES[dtype]
    d, ff = 256, 1024
    jffn = JaxFeedForward(d_ff=ff, d_model=d, dropout_rate=0.0, dtype=jdt)
    x = jax.random.normal(jax.random.PRNGKey(1), (6, 1, d)).astype(jdt)
    v = jffn.init(jax.random.PRNGKey(0), x, deterministic=True)
    ps, qs, layers = {}, {}, []
    for name in ("Dense_0", "Dense_1"):
        w = v["params"][name]["kernel"]
        w = w * (1.0 + 0.5 * jnp.cos(jnp.arange(w.shape[-1])))
        b = (0.1 * jax.random.normal(jax.random.PRNGKey(len(ps) + 5),
                                     (w.shape[1],))).astype(jdt)
        wq, s = _quantize_kernel(w)
        ps[name], qs[name] = {"kernel": wq, "bias": b}, {"kernel": s}
        layers.append(Int8Linear(torch.from_numpy(np.asarray(wq).T.copy()),
                                 torch.from_numpy(np.array(s).reshape(-1)),
                                 _t(b), tdt))
    want = jffn.apply({"params": ps, "qscales": qs}, x, deterministic=True)
    ffn = FeedForward(d, ff)
    ffn.fc1, ffn.fc2 = layers
    got = ffn(_t(x, tdt))
    assert got.dtype == tdt and got.shape == (6, 1, d)
    tol = 1e-5 if dtype == "float32" else 1e-3
    assert _row_rel_err(got.float().numpy().reshape(6, d),
                        np.asarray(want.astype(jnp.float32)).reshape(6, d)) < tol


def test_int8_feed_forward_needs_both_layers_int8():
    ffn = FeedForward(128, 256)
    w = torch.zeros(256, 128, dtype=torch.int8)
    ffn.fc1 = Int8Linear(w, torch.ones(256), torch.zeros(256), torch.float32)
    with pytest.raises(ValueError, match="both layers int8"):
        ffn(torch.zeros(2, 128))
    with pytest.raises(ValueError, match="scale"):
        Int8Linear(w, None, torch.zeros(256), torch.float32)


# The decode denses (B·K = 40 at beam 5, 8 greedy; n 1536 self-qkv, 512),
# init_cache's cross K/V projections (B·S = 1192) and chip_smoke's odd shapes.
PLAN_SHAPES = [(40, 512, 1536), (40, 512, 512), (8, 512, 1536), (8, 512, 512),
               (1192, 512, 512), (48, 2048, 6144), (1, 512, 512), (7, 96, 200)]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_int8_matmul_plan(m, k, n):
    """The bf16 kernel's tiling: rows of x a block a multiple of 8 that is
    wgmma's N (<= 256), every row of x in some block, k split into chunks
    of whole stages that cover it exactly, at most one cluster of splits,
    and as many blocks as the target asks or else as many splits as k or
    the cluster allow."""
    from speech_tranformer_pytorch_tpu_torch.kernels import int8_matmul as mm

    rows, k_chunk = mm.plan(m, k, n)
    assert rows % 8 == 0 and 8 <= rows <= min(mm.MAX_ROWS, 256)
    assert rows >= min(m, mm.MAX_ROWS)
    assert k_chunk > 0 and k_chunk % mm.STAGE_K == 0
    splits = -(-k // k_chunk)
    assert (splits - 1) * k_chunk < k <= splits * k_chunk and splits <= mm.MAX_SPLITS
    blocks = -(-n // mm.BLOCK_COLS) * -(-m // rows) * splits
    assert blocks >= mm.TARGET_BLOCKS or k_chunk == mm.STAGE_K or splits == mm.MAX_SPLITS
    if (m, k, n) in ((40, 512, 1536), (8, 512, 1536), (1192, 512, 512)):
        assert blocks >= mm.TARGET_BLOCKS


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_operands():
    """The kernel wrappers launch on CUDA tensors only (no fallback), and
    both routes check their operands before any launch."""
    from speech_tranformer_pytorch_tpu_torch.kernels import int8_ffn, int8_matmul

    x, wq, scale = (torch.from_numpy(a) for a in _matmul_case(4, 32, 16))
    with pytest.raises(ValueError, match="CUDA"):
        int8_matmul.int8_matmul_cuda(x, wq, scale)
    ffn_args = [torch.from_numpy(a) for a in _ffn_case(4, 32, 24, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        int8_ffn.int8_ffn_cuda(*ffn_args)
    with pytest.raises(ValueError, match="int8"):
        interface.int8_dense(x, wq.float(), scale)
    with pytest.raises(ValueError, match="chain"):
        interface.int8_dense(x[:, :31], wq, scale)
    with pytest.raises(ValueError, match="s2"):
        interface.int8_ffn(*ffn_args[:5], ffn_args[5][:8], ffn_args[6])
