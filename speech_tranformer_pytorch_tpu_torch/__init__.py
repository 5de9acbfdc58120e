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
"""

from . import config
from .config import ExperimentConfig, get_config

__version__ = "0.1.0"
