"""PyTorch/CUDA port of the Speech-Transformer ASR system.

The JAX package ``speech_tranformer_pytorch_tpu`` beside this one is the
reference; this package imports nothing of it (nor JAX). Module names
mirror the JAX package's so each counterpart is easy to find. Entry points
(``recognize.Recognizer``, ``decoding.beam_decode``,
``data.features.extract_features``) run on CUDA unless the caller passes
``device="cpu"``; the nine hand-written Hopper kernels (fbank, beam prune,
lineage attention, flash attention forward, dK/dV and dQ, fused Adam, int8
matmul, fused int8 feed-forward) live under ``csrc/`` and are dispatched
by ``kernels/interface.py``.

Importing the package imports nothing else of it: a serving process that
loads an exported recognizer (``serving.load_exported``) needs the kernel
operators and not the model code or the config system.
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name in ("config", "ExperimentConfig", "get_config"):
        import importlib

        config = importlib.import_module(f"{__name__}.config")
        return config if name == "config" else getattr(config, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
