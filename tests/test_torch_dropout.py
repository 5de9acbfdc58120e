"""Port u8-bit dropout (``ops/dropout.py``): its bits come from a torch
generator and cannot match JAX's, so these tests hold the invariants of the
JAX ``dropout_quantized``: keep probability (256 − q)/256 with
q = round(256·rate), kept values scaled by 256/(256 − q) in the input
dtype, identity at rate 0 and when deterministic, zeros at rate 1, and the
same bits for the same (seed, step)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.ops.dropout import (  # noqa: E402
    dropout, dropout_quantized, step_generator)


def test_keep_rate_and_scale():
    x = torch.ones(400_000)
    y = dropout_quantized(x, 0.1, step_generator(0, 0, "cpu"))
    kept = y != 0
    p = 230 / 256                               # q = round(25.6) = 26
    n = x.numel()
    assert abs(float(kept.float().mean()) - p) < 5 * np.sqrt(p * (1 - p) / n)
    assert torch.all(y[kept] == torch.tensor(256 / 230, dtype=torch.float32))


def test_scale_rounds_in_the_input_dtype():
    x = torch.full((4096,), 3.0, dtype=torch.bfloat16)
    y = dropout_quantized(x, 0.25, step_generator(1, 0, "cpu"))    # q = 64
    assert y.dtype == torch.bfloat16
    want = x[0] * torch.tensor(256 / 192, dtype=torch.bfloat16)
    assert torch.all((y == 0) | (y == want))


def test_identity_and_extremes():
    x = torch.randn(64)
    g = step_generator(0, 3, "cpu")
    assert dropout(x, 0.1, deterministic=True, generator=g) is x
    assert dropout(x, 0.0, deterministic=False, generator=g) is x
    assert dropout_quantized(x, 0.001, g) is x            # q = 0
    assert not dropout_quantized(x, 1.0, g).any()


def test_same_seed_and_step_give_the_same_bits():
    x = torch.ones(10_000)
    a = dropout_quantized(x, 0.1, step_generator(7, 2, "cpu"))
    b = dropout_quantized(x, 0.1, step_generator(7, 2, "cpu"))
    c = dropout_quantized(x, 0.1, step_generator(7, 3, "cpu"))
    d = dropout_quantized(x, 0.1, step_generator(8, 2, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


def test_model_dropout_is_reproducible_and_off_by_default():
    cfg = get_config("tiny", **{"model.num_encoder_layers": 1,
                                "model.num_decoder_layers": 1})
    model = SpeechTransformer(cfg.model).init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    args = (torch.from_numpy(rng.standard_normal((2, 60, 80)).astype(np.float32)),
            torch.tensor([60, 41]), torch.tensor([[1, 5, 6], [1, 7, 0]]),
            torch.tensor([3, 2]))
    with torch.no_grad():
        plain = model(*args)
        a = model(*args, deterministic=False, generator=step_generator(0, 5, "cpu"))
        b = model(*args, deterministic=False, generator=step_generator(0, 5, "cpu"))
    assert torch.equal(a, b) and not torch.allclose(a, plain)
    assert torch.equal(model(*args, deterministic=True), plain)
