"""Port label-smoothed CE, token accuracy and the Noam schedule against the
JAX package on the same seeded inputs (float32 at 1e-6: one log-softmax
and two reductions, summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.ops.losses import (  # noqa: E402
    label_smoothed_cross_entropy as jax_ce, token_accuracy as jax_acc)
from speech_tranformer_pytorch_tpu.ops.schedules import noam_schedule as jax_noam  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.ops.losses import (  # noqa: E402
    label_smoothed_cross_entropy, token_accuracy)
from speech_tranformer_pytorch_tpu_torch.ops.schedules import noam_schedule  # noqa: E402


def _batch(seed=0, b=3, u=7, v=50):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, u, v)) * 3).astype(np.float32)
    targets = rng.integers(1, v, size=(b, u)).astype(np.int32)
    targets[1, 4:] = 0                     # pads
    targets[2, :] = 0                      # an all-pad row
    logits[0, 0, targets[0, 0]] = 50.0     # a sure hit for the accuracy
    return logits, targets


@pytest.mark.parametrize("smoothing", [0.1, 0.0])
def test_cross_entropy_matches_jax(smoothing):
    logits, targets = _batch()
    want_loss, want_n = jax_ce(jnp.asarray(logits), jnp.asarray(targets),
                               smoothing=smoothing)
    loss, n = label_smoothed_cross_entropy(torch.from_numpy(logits),
                                           torch.from_numpy(targets), smoothing=smoothing)
    assert loss.dtype == torch.float32
    assert float(n) == float(want_n) == 11.0
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)


def test_all_pad_batch_floors_the_count():
    logits, targets = _batch()
    loss, n = label_smoothed_cross_entropy(torch.from_numpy(logits),
                                           torch.zeros_like(torch.from_numpy(targets)))
    assert float(n) == 1.0 and float(loss) == 0.0


def test_token_accuracy_matches_jax():
    logits, targets = _batch(seed=1)
    want = float(jax_acc(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(token_accuracy(torch.from_numpy(logits), torch.from_numpy(targets)))
    assert got == pytest.approx(want, abs=1e-7) and got > 0


@pytest.mark.parametrize("d_model,warmup,scale", [(512, 4000, 1.0), (256, 100, 2.0)])
def test_noam_matches_jax(d_model, warmup, scale):
    steps = np.array([0, 1, 2, 50, warmup - 1, warmup, warmup + 1, 10 * warmup], np.int32)
    want = np.asarray(jax_noam(d_model, warmup, scale)(jnp.asarray(steps)))
    got = noam_schedule(d_model, warmup, scale)(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.dtype == np.float32 and got[0] == got[1] and np.argmax(got) == 5
