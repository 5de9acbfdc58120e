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
    CLUSTER_SMEM_BYTES, CLUSTER_WARPS, candidate_topk_cuda, candidate_topk_reference,
    cluster_smem_bytes, plan)
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


@pytest.mark.parametrize("beams,k2,vocab,want", [
    (5, 10, 4336, "cluster"),     # the base preset's beam step
    (8, 16, 4336, "cluster"),     # the edge of the one-launch kernel
    (8, 16, 5000, "cluster"),     # the librispeech vocabulary
    (1, 2, 30, "cluster"),
    (9, 18, 4336, "rows"),        # more beams than a portable cluster
    (8, 17, 4336, "rows"),
    (10, 20, 4336, "rows"),
    (5, 10, 50_000, "rows"),      # the row and its buffer do not fit
])
def test_plan_takes_the_cluster_kernel_up_to_beam_8(beams, k2, vocab, want):
    assert plan(beams, k2, vocab) == want
    if want == "cluster":
        assert cluster_smem_bytes(vocab, k2) <= CLUSTER_SMEM_BYTES


def _bound_model(values, k2, threads=CLUSTER_WARPS * 32):
    """The cluster kernel's filter on one row of candidate values (a
    16-byte aligned row): rank every element in (value desc, index asc),
    take each thread's best, each warp's lane best of rank k2 - 1 and the
    best of those; returns (ranks of the kept elements, the buffer's
    capacity)."""
    v = len(values)
    order = np.lexsort((np.arange(v), -values.astype(np.float64)))
    rank = np.empty(v, np.int64)
    rank[order] = np.arange(v)
    n_vec = v // 4
    owner = np.concatenate([np.repeat(np.arange(n_vec) % threads, 4),
                            np.arange(v - 4 * n_vec)])
    best = np.full(threads, np.iinfo(np.int64).max)
    np.minimum.at(best, owner, rank)
    bounds = np.sort(best.reshape(-1, 32), axis=1)[:, k2 - 1]
    kept = rank[rank <= bounds.min()]
    cap = CLUSTER_WARPS * k2 * (4 * -(-(v // 4) // threads) + 2)
    return kept, cap


def _bound_rows():
    rng = np.random.default_rng(12)
    high_lanes = np.full(4336, -5.0, np.float32)   # the top values fill 10 lanes a warp
    for w in range(8):
        for lane in range(10):
            t = 32 * w + lane
            for c in range(t, 1084, 256):
                high_lanes[4 * c:4 * c + 4] = 5.0 + rng.random(4)
    return [("random", rng.standard_normal(4336).astype(np.float32) * 3, 10),
            ("all_equal", np.zeros(4336, np.float32), 10),
            ("V5000_k2_16", rng.standard_normal(5000).astype(np.float32), 16),
            ("tail", rng.standard_normal(4337).astype(np.float32), 10),
            ("small_vocab", rng.standard_normal(40).astype(np.float32), 8),
            ("top_values_in_10_lanes_a_warp", high_lanes, 10)]


@pytest.mark.parametrize("case", _bound_rows(), ids=lambda c: c[0])
def test_cluster_bound_keeps_every_winner_within_the_buffer(case):
    _, values, k2 = case
    kept, cap = _bound_model(values, k2)
    assert set(range(k2)) <= set(kept.tolist())     # the row's k2 best survive
    assert len(kept) <= cap
