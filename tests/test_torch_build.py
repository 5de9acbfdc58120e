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
    assert os.path.exists(os.path.join(_build.CSRC, "hopper.cuh"))
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert len(_build._digest(srcs)) == 16


def test_digest_covers_headers(tmp_path, monkeypatch):
    """An edited header (hopper.cuh, common.cuh) rebuilds the library."""
    for name in ("kernel.cu", "hopper.cuh"):
        (tmp_path / name).write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    srcs = _build._sources()
    before = _build._digest(srcs)
    (tmp_path / "hopper.cuh").write_text("// two\n")
    assert _build._digest(srcs) != before


def test_build_without_nvcc_raises():
    try:
        _build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()
    else:
        pytest.skip("nvcc is installed here")


def test_local_includes_are_headers_the_digest_covers():
    """Every header a source includes by quotes lies in csrc/ as a .cuh,
    so an edit of it rebuilds the library; the wgmma kernels include
    hopper.cuh and the f32 int8 paths int8_tile.cuh."""
    includes = {}
    for name in sorted(os.listdir(_build.CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(_build.CSRC, name)) as f:
                includes[name] = re.findall(r'#include "([^"]+)"', f.read())
    for name, found in includes.items():
        for header in found:
            assert header.endswith(".cuh"), (name, header)
            assert os.path.exists(os.path.join(_build.CSRC, header)), (name, header)
    assert {"hopper.cuh", "int8_tile.cuh"} <= set(includes["int8_matmul.cu"])
    assert "hopper.cuh" in includes["flash_attention.cu"]
    assert {"hopper.cuh", "int8_tile.cuh"} <= set(includes["int8_ffn.cu"])
