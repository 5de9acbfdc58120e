"""The port's native host libraries (counterpart of the JAX package's
``native/``): ``editdistance.cc`` scores CER and WER (``ops/metrics.py``),
``flacdec.cc`` decodes FLAC (``data/flac.py``).

Each source is compiled at its first use by the host C++ compiler (``$CXX``,
default ``g++``) with the JAX Makefile's flags into ``build/`` inside this
package (listed in ``.gitignore``), under a name that carries a hash of the
source, the flags and the host CPU, so an edited source (or another CPU) is
rebuilt, and loaded with ``ctypes``. Nothing is built when the module is imported. A build that
fails raises with the compiler's output: there is no quiet fallback. The
pure-Python versions run only when a caller asks for them
(``force_python=True``).

``call_counts`` counts the calls into each library in this process, as
``kernels/interface.launch_counts`` counts kernel launches; a DataLoader
worker's calls are counted in that worker.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from typing import Dict

SOURCE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(SOURCE_DIR), "build")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

I32P = ctypes.POINTER(ctypes.c_int32)
I64P = ctypes.POINTER(ctypes.c_int64)
U8P = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.c_int64
# library -> {symbol: (restype, argtypes)}
SIGNATURES = {
    "editdistance": {
        # ref, n, hyp, m -> distance
        "edit_distance_i32": (_I64, [I32P, _I64, I32P, _I64]),
        # refs, ref_offsets, hyps, hyp_offsets, num_pairs, out[2]
        "edit_distance_corpus_i32": (None, [I32P, I64P, I32P, I64P, _I64, I64P]),
    },
    "flacdec": {
        # data, len, out, max_samples, rate, channels, bps -> samples or < 0
        "flac_decode": (_I64, [U8P, _I64, I32P, _I64, I32P, I32P, I32P]),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_calls: Dict[str, int] = {sym: 0 for syms in SIGNATURES.values() for sym in syms}


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags: ``-march=native`` builds for
    them, so a checkout shared between machines keeps a library for each."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor().encode()
    return b"\n".join(sorted({ln for ln in lines
                               if ln.startswith((b"model name", b"flags"))}))


def build(name: str) -> str:
    """Compile ``<name>.cc`` if needed; returns the library's path. Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    src = os.path.join(SOURCE_DIR, f"{name}.cc")
    cxx = _compiler()
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join([cxx, *CXX_FLAGS]).encode()
                                + _host_cpu())
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = os.path.join(tmp, "lib.so")
        try:
            res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp_so, src],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the C++ compiler {cxx!r} to build "
                               f"{name}.cc: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build {name}.cc:\n{res.stdout}")
        os.replace(tmp_so, so)   # atomic: a concurrent build never sees half a file
    return so


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built at first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for sym, (restype, argtypes) in SIGNATURES[name].items():
                fn = getattr(lib, sym)
                fn.restype, fn.argtypes = restype, argtypes
            _libs[name] = lib
        return lib


def count(symbol: str) -> None:
    """Count one call of ``symbol`` (made by its wrapper, where it calls)."""
    with _lock:
        _calls[symbol] += 1


def call_counts() -> Dict[str, int]:
    with _lock:
        return dict(_calls)


def reset_call_counts() -> None:
    with _lock:
        for sym in _calls:
            _calls[sym] = 0
