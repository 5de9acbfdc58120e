"""Fixtures of the benchmark's own tests. They run on the CPU at tiny
sizes; a test marked ``chip`` needs a CUDA card, which the ``cuda``
fixture looks for when the test runs (never at import)."""

from __future__ import annotations

import copy
import time

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (run on the chip)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest portbench/tests -m chip` on the chip")
    return torch.device("cuda", 0)


def tiny_config(dtype: str = "float32") -> dict:
    """The port's ``tiny`` preset as a configuration dictionary: dropout and
    SpecAugment on, so every part the reference covers runs."""
    from speech_tranformer_pytorch_tpu_torch.config import get_config

    cfg = get_config("tiny").to_dict()
    cfg["model"].update(d_model=64, num_heads=4, d_ff=128, num_encoder_layers=2,
                        num_decoder_layers=2, subsample_channels=8, vocab_size=40,
                        dtype=dtype, dropout_rate=0.1)
    cfg["features"]["output_dtype"] = dtype
    cfg["spec_augment"].update(enabled=True, num_time_masks=4, time_masks_per_frame=0.05)
    cfg["train"].update(batch_size=4, warmup_steps=10)
    return cfg


def tiny_mix(entry: str) -> dict:
    mix = {"entry": entry, "why": "tiny",
           "lengths": {"buckets": [100, 200], "batches_per_bucket": 2, "min_s": 0.5},
           "lengths_seed": 0, "batch": 3, "signal_seconds": 4.0,
           "trace_items": 2}
    if entry == "serve":
        mix.update(decode={"beam_size": 3, "alpha": 1.0, "max_len_ratio": 0.5,
                           "max_decode_len": 6}, check_calls=2)
    else:
        mix.update(tokens_per_s=4.0, check_steps=3)
    return mix


def tiny_context(entry: str, *, seed: int = 3, dtype: str = "float32", seconds=0.5,
                 trace: bool = False, limits=None, mix=None):
    from portbench.harness import Context

    cfg = tiny_config(dtype)
    return Context(cell=f"tiny.{entry}", config={"config": cfg}, mix=copy.deepcopy(mix or tiny_mix(entry)),
                   limits=limits or {}, seed=seed, seconds=seconds, trace=trace,
                   device=torch.device("cpu"), t_start=time.perf_counter())
