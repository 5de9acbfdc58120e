"""Host-side tables and index math of the port's FFT fbank kernel.

The kernel (csrc/stft_mel.cu) runs only on a card, so its inputs and its
decomposition are held here: the sparse mel table rebuilds the dense mel
matrix exactly, the twiddle and window tables are their float64 values
rounded to f32, and a numpy model of the kernel's real FFT (a half-length
complex FFT, P points in registers and 32 across lanes, then the split
step, in the kernel's index order and with its table) equals np.fft.rfft
to 1e-10 in float64. chip_smoke.py holds the kernel itself to its plain
version on the card."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu_torch.config import PRESETS, FeatureConfig, get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.features import (  # noqa: E402
    make_mel_matrix, make_window)
from speech_tranformer_pytorch_tpu_torch.kernels import interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels.stft_mel import (  # noqa: E402
    FFT_LENGTHS, bit_reverse, fft_tables, kernel_for, lane_twiddles, log_mel_cuda,
    log_mel_reference, sparse_mel)


def _dense(index, weights, n_bins):
    mel = np.zeros((n_bins, index.shape[1]), np.float32)
    for m, (first, count, offset) in enumerate(index.T):
        mel[first:first + count, m] = weights[offset:offset + count]
    return mel


_MEL_CASES = [(name, get_config(name).features) for name in sorted(PRESETS)] + [
    ("low_freq=64,high_freq=-400", FeatureConfig(low_freq=64.0, high_freq=-400.0)),
    ("low_freq=0,high_freq=7600", FeatureConfig(low_freq=0.0, high_freq=7600.0)),
]


@pytest.mark.parametrize("case", _MEL_CASES, ids=lambda c: c[0])
def test_sparse_mel_table_rebuilds_the_mel_matrix(case):
    _, cfg = case
    mel = make_mel_matrix(cfg.num_mel_bins, cfg.fft_length, cfg.sample_rate,
                          cfg.low_freq, cfg.high_freq)
    index, weights = sparse_mel(mel)
    assert index.dtype == np.int32 and weights.dtype == np.float32
    np.testing.assert_array_equal(_dense(index, weights, mel.shape[0]), mel)
    first, count, offset = index
    np.testing.assert_array_equal(offset, np.concatenate([[0], np.cumsum(count)[:-1]]))
    assert weights.size == count.sum()
    assert (first + count <= mel.shape[0]).all()
    _, _, t_index, t_weights = fft_tables(cfg)
    np.testing.assert_array_equal(t_index, index)
    np.testing.assert_array_equal(t_weights, weights)


def _twiddle_rows_f64(nfft):
    """The kernel's rows (csrc/stft_mel.cu ``Rows<P>``) written out one by
    one in float64: exp(-2 pi i e / n) for each lane."""
    p, n = nfft // 64, nfft // 2
    pb = int(math.log2(p))
    w = lambda e, d: np.exp(-2j * np.pi * e / d)
    rows = []
    for h in (16, 8, 4, 2):
        rows.append([w(lane % h, 2 * h) if lane & h else 1.0 for lane in range(32)])
    for i in range(1, p):
        rows.append([w(lane * bit_reverse(i, pb), n) for lane in range(32)])
    for h in (2 ** s for s in range(pb)):
        for j in range(h):
            rows.append([w(j, 2 * h)] * 32)
    for i in range(p):
        rows.append([w(bit_reverse(i, pb) + p * bit_reverse(lane, 5), 2 * n)
                     for lane in range(32)])
    return np.array(rows, np.complex128)


@pytest.mark.parametrize("nfft", FFT_LENGTHS)
def test_twiddles_are_float64_values_rounded_to_f32(nfft):
    want = _twiddle_rows_f64(nfft)
    got = lane_twiddles(nfft)
    assert got.dtype == np.float32 and got.shape == (2,) + want.shape
    np.testing.assert_array_equal(got[0], want.real.astype(np.float32))
    np.testing.assert_array_equal(got[1], want.imag.astype(np.float32))


@pytest.mark.parametrize("window", ["povey", "hann", "hamming"])
def test_window_table_is_float64_window_rounded_to_f32_and_zero_padded(window):
    cfg = FeatureConfig(window=window)
    table = fft_tables(cfg)[0]
    L = cfg.frame_length
    n = np.arange(L, dtype=np.float64)
    a = 2.0 * math.pi / (L - 1)
    want = {"povey": (0.5 - 0.5 * np.cos(a * n)) ** 0.85,
            "hann": 0.5 - 0.5 * np.cos(a * n),
            "hamming": 0.54 - 0.46 * np.cos(a * n)}[window]
    assert table.dtype == np.float32 and table.shape == (cfg.fft_length,)
    np.testing.assert_array_equal(table[:L], want.astype(np.float32))
    np.testing.assert_array_equal(table[:L], make_window(window, L))
    assert not table[L:].any()


def _kernel_rfft(y, nfft):
    """numpy model of stft_mel_fft_kernel's real FFT, in float64 with the
    kernel's table: X[0 .. N] of the real frame y [nfft]."""
    p = nfft // 64
    n = 32 * p
    pb = int(math.log2(p))
    tw = lane_twiddles(nfft, np.float64)
    w = tw[0] + 1j * tw[1]                         # [rows, 32]
    cross, step, regs, split = 0, 4, 3 + p, 2 + 2 * p
    lane = np.arange(32)
    # lane l, register i: z[32 i + l] = y[64 i + 2 l] + i y[64 i + 2 l + 1]
    reg = np.stack([y[64 * i + 2 * lane] + 1j * y[64 * i + 2 * lane + 1]
                    for i in range(p)], axis=1)
    for stage in range(pb):                         # P-point DIF in registers
        h = p >> (stage + 1)
        for blk in range(0, p, 2 * h):
            for j in range(h):
                u, v = blk + j, blk + j + h
                d = reg[:, u] - reg[:, v]
                reg[:, u] = reg[:, u] + reg[:, v]
                reg[:, v] = d if j == 0 else -1j * d if 4 * j == 2 * h else d * w[regs + h + j - 1]
    for i in range(1, p):                           # W_N^(l rev_P(i))
        reg[:, i] *= w[step + i - 1]
    for stage in range(5):                          # 32-point DIF across lanes
        h = 16 >> stage
        partner = reg[lane ^ h]
        reg = np.where((lane & h)[:, None] != 0, partner - reg, reg + partner)
        if stage < 4:
            reg = reg * w[cross + stage][:, None]
    c = np.array([bit_reverse(x, 5) for x in lane])
    src0 = np.array([bit_reverse((32 - x) & 31, 5) for x in c])
    x = np.zeros(n + 1, np.complex128)
    for i in range(p):                              # split step, Z[N-k] by lane
        b = bit_reverse(i, pb)
        zk = reg[:, i]
        zm = reg[src0, 0] if b == 0 else reg[lane ^ 31, bit_reverse(p - b, pb)]
        e = 0.5 * (zk + np.conj(zm))
        o = 0.5 * (zk - np.conj(zm)) / 1j
        x[b + p * c] = e + w[split + i] * o
    x[n] = reg[0, 0].real - reg[0, 0].imag
    return x


@pytest.mark.parametrize("nfft,frame", [(128, 100), (256, 200), (256, 256), (512, 400),
                                        (512, 512), (1024, 400)])
def test_kernel_real_fft_model_equals_rfft(nfft, frame):
    y = np.zeros(nfft)
    y[:frame] = np.random.default_rng(nfft + frame).standard_normal(frame)
    got = _kernel_rfft(y, nfft)
    want = np.fft.rfft(y)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("kw,want", [
    ({}, "fft"),                                          # every preset: 400 / 512
    ({"fft_length": 400}, "dft"),                         # not a power of two
    ({"fft_length": 256}, "dft"),                         # shorter than the frame
    ({"fft_length": 2048}, "dft"),                        # past the FFT kernel's range
    ({"fft_length": 256, "frame_length_ms": 12.5}, "fft"),
    ({"fft_length": 1024}, "fft"),
])
def test_stft_kernel_choice_by_shape(kw, want):
    assert kernel_for(FeatureConfig(**kw)) == want


def test_every_preset_takes_the_fft_kernel():
    assert {kernel_for(get_config(name).features) for name in PRESETS} == {"fft"}


def test_stft_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        log_mel_cuda(torch.zeros(2, 16000), FeatureConfig(), 98)


def test_interface_log_mel_uses_plain_path_on_cpu():
    wave = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 4000)).astype(np.float32))
    before = dict(interface.launch_counts())
    got = interface.log_mel(wave, FeatureConfig(), 23)
    assert interface.launch_counts() == before
    torch.testing.assert_close(got, log_mel_reference(wave, FeatureConfig(), 23), rtol=0, atol=0)
