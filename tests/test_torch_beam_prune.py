"""Port beam-candidate top-k against the JAX package's Pallas kernel
(interpret mode) and its jnp reference: every case of
tests/test_beam_prune_kernel.py, indices exact (tie order included) and
values within 1e-6. The port's CUDA kernel is held against the same plain
version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.kernels.beam_prune import (  # noqa: E402
    candidate_topk, candidate_topk_reference as jax_reference)
from speech_tranformer_pytorch_tpu_torch.kernels import interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels.beam_prune import (  # noqa: E402
    candidate_topk_cuda, candidate_topk_reference)
from speech_tranformer_pytorch_tpu_torch.ops.topk import topk_stable  # noqa: E402


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cases():
    """(name, logits [B·K, V], alive [B, K], k2) — the JAX golden cases."""
    zeros = lambda bk, v: np.zeros((bk, v), np.float32)
    dead = np.array([0.0] + [-1e9] * 3, np.float32)
    more = zeros(2, 64)
    more[0, :] = 5.0
    spikes = _normal((6, 33), 5)
    spikes[:, 0], spikes[:, 1] = 100.0, 99.0
    return [
        ("random", _normal((15, 97), 0), _normal((3, 5), 1), 10),
        ("neg_inf_alive", _normal((8, 50), 2), np.tile(dead, (2, 1)), 8),
        ("ties_within_row", zeros(2, 40), np.array([[0.0, -0.5]], np.float32), 4),
        ("ties_across_beams", zeros(3, 16), np.zeros((1, 3), np.float32), 6),
        ("more_than_k2_ties", more, np.array([[0.0, -1.0]], np.float32), 5),
        ("special_token_masking", spikes, np.zeros((2, 3), np.float32), 4),
        ("tiny_vocab_saturation", _normal((2, 6), 6),
         np.array([[0.0, -1e9]], np.float32), 6),
        ("all_dead_rows", _normal((6, 8), 7), np.full((2, 3), -1e9, np.float32), 6),
        ("base_shapes", _normal((40, 512), 8), _normal((8, 5), 9) * 5, 10),
    ]


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_matches_jax_kernel_and_reference(case):
    name, logits, alive, k2 = case
    got_v, got_i = candidate_topk_reference(
        torch.from_numpy(logits), torch.from_numpy(alive), k2=k2)
    ker_v, ker_i = candidate_topk(jnp.asarray(logits), jnp.asarray(alive), k2=k2,
                                  interpret=True)
    ref_v, ref_i = jax_reference(jnp.asarray(logits), jnp.asarray(alive), k2=k2)
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.float32
    for want_v, want_i in ((ker_v, ker_i), (ref_v, ref_i)):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                                   rtol=1e-6, atol=1e-6)
    if name == "special_token_masking":      # <pad>/<sos> never win
        assert not np.isin(got_i.numpy() % logits.shape[1], [0, 1]).any()


def test_interface_uses_plain_path_on_cpu():
    logits, alive = _normal((10, 30), 10), _normal((2, 5), 11)
    before = dict(interface.launch_counts())
    got = interface.beam_candidate_topk(torch.from_numpy(logits),
                                        torch.from_numpy(alive), k2=10)
    want = candidate_topk_reference(torch.from_numpy(logits),
                                    torch.from_numpy(alive), k2=10)
    assert interface.launch_counts() == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_topk_stable_breaks_ties_by_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, -np.inf, 3.0, 2.0, 2.0]])
    vals, idx = topk_stable(x, 6)
    assert idx.tolist() == [[1, 2, 4, 5, 6, 0]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0, 2.0, 1.0]]


def test_kernel_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        candidate_topk_cuda(torch.zeros(10, 30), torch.zeros(2, 5), k2=10)
