"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` unless the caller names another device.

    Never falls back: with no device given and no CUDA card this raises.
    On a CUDA device it also turns TF32 off for matmuls and cuDNN
    convolutions (cuDNN defaults to TF32, which keeps ~3 decimal digits),
    so float32 runs on the card compute in full float32 like the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
