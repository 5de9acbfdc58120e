"""Port fbank, CMVN and extract_features against the JAX package.

The same seeded numpy audio goes through the JAX front-end (its Pallas
fbank kernel in interpret mode, and its jnp path) and the port's plain
PyTorch path on the CPU. Tolerances are the JAX kernel goldens' own: 1e-3
on the float32 log-mel (tests/test_stft_mel_kernel.py), 2e-2 after the
bfloat16 output cast (one bf16 rounding of values of order 1)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import FeatureConfig as JFeatureConfig  # noqa: E402
from speech_tranformer_pytorch_tpu.data import features as jfeat  # noqa: E402
from speech_tranformer_pytorch_tpu.kernels.stft_mel import (  # noqa: E402
    _effective_matrices as j_effective_matrices, log_mel_pallas)
from speech_tranformer_pytorch_tpu_torch.config import FeatureConfig  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data import features as pfeat  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels import interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels.stft_mel import (  # noqa: E402
    _effective_matrices, log_mel_cuda)


def _both_log_mel(wave, **kw):
    jcfg, pcfg = JFeatureConfig(cmvn=False, **kw), FeatureConfig(cmvn=False, **kw)
    n = jfeat.num_frames(wave.shape[-1], jcfg.frame_length, jcfg.frame_shift)
    want_jnp = np.asarray(jfeat._log_mel_impl(jnp.asarray(wave), jcfg, n, None))
    want_kernel = np.asarray(log_mel_pallas(jnp.asarray(wave), jcfg, n))
    got = pfeat.log_mel_spectrogram(torch.from_numpy(wave), pcfg).numpy()
    return got, want_jnp, want_kernel


@pytest.mark.parametrize("shape", [(2, 16000), (7231,)])
def test_log_mel_matches_jax(shape):
    wave = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got, want_jnp, want_kernel = _both_log_mel(wave)
    assert got.shape == want_jnp.shape
    np.testing.assert_allclose(got, want_jnp, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got, want_kernel, rtol=1e-3, atol=1e-3)


def test_no_preemph_no_log_variant():
    wave = np.random.default_rng(1).standard_normal((1, 8000)).astype(np.float32)
    got, want_jnp, want_kernel = _both_log_mel(
        wave, preemphasis=0.0, use_log=False, window="hann")
    np.testing.assert_allclose(got, want_jnp, rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(got, want_kernel, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("window", ["povey", "hann", "hamming"])
def test_effective_matrices_equal_jax(window):
    jc, js, jm = j_effective_matrices(JFeatureConfig(window=window))
    c, s, m = _effective_matrices(FeatureConfig(window=window))
    n_bins = c.shape[1]
    assert n_bins == 257
    np.testing.assert_array_equal(c, jc[:, :n_bins])
    np.testing.assert_array_equal(s, js[:, :n_bins])
    np.testing.assert_array_equal(m, jm[:n_bins])
    np.testing.assert_array_equal(pfeat.make_window(window, 400),
                                  jfeat.make_window(window, 400))


def test_frame_lengths_and_cmvn_match_jax():
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((3, 50, 8)).astype(np.float32) * 3 + 1
    slens = np.array([160 * 49 + 400, 399, 160 * 20 + 450], np.int32)
    jl = np.asarray(jfeat.frame_lengths_from_sample_lengths(jnp.asarray(slens), 400, 160))
    pl = pfeat.frame_lengths_from_sample_lengths(torch.from_numpy(slens), 400, 160)
    np.testing.assert_array_equal(pl.numpy(), jl)
    want = np.asarray(jfeat.apply_cmvn(jnp.asarray(feats), jnp.asarray(jl)))
    got = pfeat.apply_cmvn(torch.from_numpy(feats), pl).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[1].any()                      # zero valid frames -> zeros


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", 2e-2)])
def test_extract_features_int16_matches_jax(dtype, tol):
    audio, lens = make_utterances(3, min_seconds=0.6, max_seconds=1.5, seed=4)
    jcfg = JFeatureConfig(output_dtype=dtype)
    want, wl = jfeat.extract_features(jnp.asarray(audio), jnp.asarray(lens), jcfg)
    before = dict(interface.launch_counts())
    got, gl = pfeat.extract_features(audio, lens, FeatureConfig(output_dtype=dtype),
                                     device="cpu")
    assert interface.launch_counts() == before   # CPU path launches no kernel
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_kernel_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        log_mel_cuda(torch.zeros(1, 800), FeatureConfig(), 3)
