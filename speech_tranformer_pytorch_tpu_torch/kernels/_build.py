"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``speech_tranformer_pytorch_tpu_torch/csrc/`` is
compiled by ``nvcc`` for ``sm_90a`` (one process per source, all started
together) and linked into one shared library with a plain C interface,
loaded with ``ctypes``. The library goes into ``build/`` inside this
package (listed in ``.gitignore``); its name carries a hash of the sources
and flags, so an edited source is rebuilt at its first use. Nothing is
built when the module is imported: ``library()`` builds on the first
kernel launch.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_LP = ctypes.POINTER(ctypes.c_longlong)   # a host int64 array
# C signatures: every entry point returns cudaError_t as int.
SIGNATURES = {
    # wave, window, twiddle, mel_index, mel_w, out, batch, num_samples,
    # n_frames, frame_len, hop, fft_len, n_mels, n_weights, preemph,
    # use_log, log_floor, stream
    "st_stft_mel": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _F,
                    _P],
    # wave, c_eff, s_eff, mel, out, batch, num_samples, n_frames,
    # frame_len, hop, n_bins, n_mels, use_log, log_floor, stream
    "st_stft_mel_dft": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # logits, alive, vals, idx, batch, beams, vocab, k2, pad_id, sos_id,
    # stream
    "st_beam_prune": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # logits, alive, row_vals, row_idx, vals, idx, batch, beams, vocab, k2,
    # pad_id, sos_id, stream
    "st_beam_prune_rows": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, lineage, out, batch, beams, max_len, heads, head_dim,
    # index, is_bf16, stream
    "st_lineage_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, o, lse, kv_len, strides[24], batch, heads, tq, tk, head_dim,
    # causal, is_bf16, vec, stream
    "st_flash_fwd": [_P, _P, _P, _P, _P, _P, _LP, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, dout, lse, di, dk, dv, kv_len, strides[24], batch, heads, tq,
    # tk, head_dim, causal, is_bf16, vec, stream
    "st_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LP, _I, _I, _I, _I,
                         _I, _I, _I, _I, _P],
    # q, k, v, dout, lse, di, dq, kv_len, strides[24], batch, heads, tq, tk,
    # head_dim, causal, is_bf16, vec, stream
    "st_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _LP, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P],
    # leaves, n_leaves, max_numel, scalars, b1, 1-b1, b2, 1-b2, eps,
    # weight_decay, bf16_moments, stream
    "st_fused_adam": [_P, _I, _L, _P, _F, _F, _F, _F, _F, _F, _I, _P],
    # x, wq, scale, y, m, k, n, ldx, rows, k_chunk, is_bf16, stream
    "st_int8_matmul": [_P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _P],
    # x, w1q, s1, b1, w2q, s2, b2, y, partial, counters, m, k, ff, n, ldx,
    # rows, hidden_tiles, col_tiles, ranks, is_bf16, stream
    "st_int8_ffn": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I,
                    _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc on the machine with the card")


def _sources() -> list:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile the kernels if needed; returns the library's path.

    ``verbose`` adds ``-Xptxas -v`` to a build that happens and prints
    nvcc's report (registers, shared memory, spills per kernel); a library
    already built from the same sources is reused either way."""
    srcs = _sources()
    so = os.path.join(BUILD_DIR, f"libst_kernels_{_digest(srcs)}.so")
    if os.path.exists(so):
        return so
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in srcs:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *flags, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            if verbose and out:
                print(out, flush=True)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = os.path.join(tmp, "lib.so")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_so,
                *[obj for _, obj, _ in procs]]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        os.replace(tmp_so, so)   # atomic: a concurrent build never sees half a file
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.st_error_string.argtypes = [ctypes.c_int]
        lib.st_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        text = library().st_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {text}")


def stream_ptr(device) -> ctypes.c_void_p:
    """Handle of PyTorch's current stream on ``device``."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
