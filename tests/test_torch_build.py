"""The port's kernel build, checked without a CUDA toolkit.

The kernels compile only where nvcc and a card exist (``chip_smoke.py``),
so here the Python side of the ctypes binding is held to the C sources:
every bound entry point exists with the same number of parameters, and a
build without nvcc fails loudly instead of falling back."""

import os
import re

import pytest

pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu_torch.kernels import _build  # noqa: E402


def _c_entry_points():
    found = {}
    for name in sorted(os.listdir(_build.CSRC)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(_build.CSRC, name)) as f:
            src = f.read()
        for m in re.finditer(r'extern "C" \w+\s*\*?\s*(st_\w+)\(([^)]*)\)', src):
            found[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    return found


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signature_matches_c_source(name):
    entries = _c_entry_points()
    assert name in entries, f"{name} not defined in {_build.CSRC}"
    assert entries[name] == len(_build.SIGNATURES[name])


def test_every_source_is_built_for_sm_90a():
    srcs = _build._sources()
    assert {os.path.basename(s) for s in srcs} >= {
        "stft_mel.cu", "beam_prune.cu", "lineage_attention.cu", "flash_attention.cu",
        "fused_adam.cu", "int8_matmul.cu", "int8_ffn.cu"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert len(_build._digest(srcs)) == 16


def test_build_without_nvcc_raises():
    try:
        _build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()
    else:
        pytest.skip("nvcc is installed here")
