"""FLAC codec (counterpart of the JAX package's ``data/flac.py``): the
LibriSpeech recipe reads its ``.flac`` files through it.

- ``decode_flac_py`` decodes the subset libFLAC-encoded speech corpora use:
  CONSTANT / VERBATIM / FIXED (orders 0-4) / LPC (orders 1-32) subframes,
  Rice and Rice2 partitioned residuals with the escape code, wasted-bits
  shifts, every block-size / sample-rate / sample-size header code, mono
  and all four stereo channel assignments, 8/16/24-bit depths, and the
  header CRC-8 and frame CRC-16 checks. It is the plain reference.
- ``decode_flac`` reads a path or bytes and decodes them with the native
  decoder ``native/flacdec.cc`` (built with the host compiler at first use;
  a failed build raises), which decodes the same subset bit for bit.
  ``force_python=True`` takes ``decode_flac_py`` instead. A stream whose
  STREAMINFO gives no sample count goes to ``decode_flac_py``, as in the
  JAX package: the native decoder needs it to size its output.
- ``flac_info`` reads STREAMINFO only, so manifests record lengths without
  a decode.
- ``write_flac`` encodes fixed-predictor and quantized-LPC subframes with
  partitioned Rice residuals; the tests and ``chip_smoke.py`` write their
  fixtures with it. Its bytes equal the JAX package's.

Bit-level formats follow the public FLAC format specification (RFC 9639).
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import List, Tuple

import numpy as np

from .. import native

__all__ = ["decode_flac", "decode_flac_py", "write_flac", "flac_info",
           "FlacError"]


class FlacError(ValueError):
    pass


# ---------------------------------------------------------------------------
# CRCs (FLAC polynomials: CRC-8 x^8+x^2+x+1, CRC-16 x^16+x^15+x^2+1)
# ---------------------------------------------------------------------------

def _make_crc8_table():
    tab = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
        tab.append(c)
    return tab


def _make_crc16_table():
    tab = []
    for i in range(256):
        c = i << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
        tab.append(c)
    return tab


_CRC8 = _make_crc8_table()
_CRC16 = _make_crc16_table()


def _crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8[c ^ b]
    return c


def _crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC16[((c >> 8) ^ b) & 0xFF] ^ ((c << 8) & 0xFFFF)
    return c


# ---------------------------------------------------------------------------
# Bit reader / writer
# ---------------------------------------------------------------------------

class _BitReader:
    """MSB-first bit reader over a bytes object."""

    def __init__(self, data: bytes, pos_bytes: int = 0):
        self.data = data
        self.pos = pos_bytes * 8          # absolute bit position

    def read(self, n: int) -> int:
        """Read n bits as an unsigned int."""
        v = 0
        pos, data = self.pos, self.data
        end = pos + n
        if end > len(data) * 8:
            raise FlacError("unexpected end of stream")
        while n > 0:
            byte = data[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, n)
            shift = avail - take
            v = (v << take) | ((byte >> shift) & ((1 << take) - 1))
            pos += take
            n -= take
        self.pos = pos
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if v >= (1 << (n - 1)):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        """Count 0 bits until the terminating 1 bit."""
        q = 0
        pos, data = self.pos, self.data
        nbits = len(data) * 8
        while True:
            if pos >= nbits:
                raise FlacError("unexpected end of stream in unary code")
            byte = data[pos >> 3]
            rem = 8 - (pos & 7)
            chunk = byte & ((1 << rem) - 1)
            if chunk == 0:
                q += rem
                pos += rem
                continue
            lead = rem - chunk.bit_length()
            q += lead
            pos += lead + 1
            break
        self.pos = pos
        return q

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.pos >> 3


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nacc = 0

    def write(self, value: int, n: int):
        if n == 0:
            return
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nacc += n
        while self.nacc >= 8:
            self.nacc -= 8
            self.buf.append((self.acc >> self.nacc) & 0xFF)
        self.acc &= (1 << self.nacc) - 1

    def write_signed(self, value: int, n: int):
        self.write(value & ((1 << n) - 1), n)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self.nacc:
            self.write(0, 8 - self.nacc)

    def getvalue(self) -> bytes:
        assert self.nacc == 0, "unaligned"
        return bytes(self.buf)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

_BLOCKSIZE_CODE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                   8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                   13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATE_CODE = {0: None, 1: 88200, 2: 176400, 3: 192000, 4: 8000,
                     5: 16000, 6: 22050, 7: 24000, 8: 32000, 9: 44100,
                     10: 48000, 11: 96000}
_SAMPLE_SIZE_CODE = {0: None, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _read_utf8_number(br: _BitReader) -> int:
    """FLAC's extended UTF-8-style frame/sample number coding."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x80
    while b0 & mask:
        n += 1
        mask >>= 1
    if n < 2 or n > 7:
        raise FlacError(f"bad UTF-8 coded number lead byte {b0:#x}")
    v = b0 & (0xFF >> (n + 1))
    for _ in range(n - 1):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise FlacError("bad UTF-8 coded number continuation")
        v = (v << 6) | (b & 0x3F)
    return v


def _decode_residual(br: _BitReader, blocksize: int, order: int) -> List[int]:
    method = br.read(2)
    if method > 1:
        raise FlacError(f"reserved residual coding method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    porder = br.read(4)
    nparts = 1 << porder
    if blocksize % nparts:
        raise FlacError("block size not divisible by partition count")
    part = blocksize >> porder
    if part <= 0 or (nparts == 1 and part <= order) or (part < order):
        raise FlacError("bad partition order")
    out: List[int] = []
    for p in range(nparts):
        count = part - order if p == 0 else part
        param = br.read(plen)
        if param == escape:
            bits = br.read(5)
            if bits == 0:
                out.extend([0] * count)
            else:
                for _ in range(count):
                    out.append(br.read_signed(bits))
        else:
            for _ in range(count):
                q = br.read_unary()
                low = br.read(param) if param else 0
                v = (q << param) | low
                out.append((v >> 1) ^ -(v & 1))
    return out


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise FlacError("subframe header padding bit set")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
        bps -= wasted

    if stype == 0:              # CONSTANT
        v = br.read_signed(bps)
        samples = np.full(blocksize, v, np.int64)
    elif stype == 1:            # VERBATIM
        samples = np.array([br.read_signed(bps) for _ in range(blocksize)],
                           np.int64)
    elif 8 <= stype <= 12:      # FIXED, order 0-4
        order = stype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        resid = _decode_residual(br, blocksize, order)
        coeffs = _FIXED_COEFFS[order]
        x = warm + [0] * (blocksize - order)
        for i in range(order, blocksize):
            acc = resid[i - order]
            for j, c in enumerate(coeffs):
                acc += c * x[i - 1 - j]
            x[i] = acc
        samples = np.array(x, np.int64)
    elif stype >= 32:           # LPC, order 1-32
        order = (stype & 31) + 1
        warm = [br.read_signed(bps) for _ in range(order)]
        prec = br.read(4)
        if prec == 15:
            raise FlacError("invalid LPC coefficient precision")
        prec += 1
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coeffs = [br.read_signed(prec) for _ in range(order)]
        resid = _decode_residual(br, blocksize, order)
        x = warm + [0] * (blocksize - order)
        for i in range(order, blocksize):
            acc = 0
            for j in range(order):
                acc += coeffs[j] * x[i - 1 - j]
            x[i] = resid[i - order] + (acc >> shift)
        samples = np.array(x, np.int64)
    else:
        raise FlacError(f"reserved subframe type {stype}")

    if wasted:
        samples = samples << wasted
    return samples


def decode_flac_py(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Pure-Python FLAC decoder (the behavioral reference).

    Returns ``(samples[int32, shape (n, channels)], sample_rate, bps)``.
    """
    if data[:4] != b"fLaC":
        raise FlacError("not a FLAC stream (missing fLaC marker)")
    pos = 4
    streaminfo = None
    while True:
        if pos + 4 > len(data):
            raise FlacError("truncated metadata")
        hdr = data[pos]
        last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        blen = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + blen]
        if btype == 0:
            if blen < 34:
                raise FlacError("short STREAMINFO")
            br = _BitReader(body)
            br.read(16)  # min blocksize
            br.read(16)  # max blocksize
            br.read(24)
            br.read(24)
            rate = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
            streaminfo = (rate, channels, bps, total)
        pos += 4 + blen
        if last:
            break
    if streaminfo is None:
        raise FlacError("no STREAMINFO block")
    si_rate, si_channels, si_bps, si_total = streaminfo

    chunks: List[np.ndarray] = []
    got = 0
    while pos < len(data) and (si_total == 0 or got < si_total):
        hdr_start = pos
        br = _BitReader(data, pos)
        sync = br.read(14)
        if sync != 0x3FFE:
            raise FlacError(f"bad frame sync {sync:#x} at byte {pos}")
        if br.read(1):
            raise FlacError("frame header reserved bit set")
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        chan_code = br.read(4)
        ss_code = br.read(3)
        if br.read(1):
            raise FlacError("frame header reserved bit 2 set")
        _read_utf8_number(br)
        if bs_code == 0:
            raise FlacError("reserved block size code 0")
        elif bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        else:
            blocksize = _BLOCKSIZE_CODE[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        elif sr_code == 15:
            raise FlacError("invalid sample rate code")
        bps = _SAMPLE_SIZE_CODE.get(ss_code)
        if ss_code == 3:
            raise FlacError("reserved sample size code")
        if bps is None:
            bps = si_bps
        br.align()
        header_bytes = data[hdr_start:br.byte_pos()]
        crc = br.read(8)
        if crc != _crc8(header_bytes):
            raise FlacError("frame header CRC-8 mismatch")

        if chan_code < 8:
            nchan = chan_code + 1
            subs = [_decode_subframe(br, blocksize, bps)
                    for _ in range(nchan)]
            frame = np.stack(subs, axis=1)
        elif chan_code in (8, 9, 10):
            side_first = 1 if chan_code == 9 else 0
            bps0 = bps + (1 if chan_code == 9 else 0)
            bps1 = bps + (0 if chan_code == 9 else 1)
            c0 = _decode_subframe(br, blocksize, bps0)
            c1 = _decode_subframe(br, blocksize, bps1)
            if chan_code == 8:      # left/side: R = L - side
                left, right = c0, c0 - c1
            elif chan_code == 9:    # right/side: L = R + side
                left, right = c1 + c0, c1
            else:                   # mid/side
                mid, side = c0, c1
                mid = (mid << 1) | (side & 1)
                left = (mid + side) >> 1
                right = (mid - side) >> 1
            frame = np.stack([left, right], axis=1)
        else:
            raise FlacError(f"reserved channel assignment {chan_code}")

        br.align()
        # frame CRC-16 (over everything from sync through subframes)
        body_bytes = data[hdr_start:br.byte_pos()]
        crc16 = br.read(16)
        if crc16 != _crc16(body_bytes):
            raise FlacError("frame CRC-16 mismatch")
        chunks.append(frame)
        got += blocksize
        pos = br.byte_pos()

    if not chunks:
        return np.zeros((0, si_channels), np.int32), si_rate, si_bps
    out = np.concatenate(chunks, axis=0).astype(np.int32)
    if si_total:
        out = out[:si_total]
    return out, si_rate, si_bps


def flac_info(source) -> Tuple[int, int, int, int]:
    """Read STREAMINFO only (no frame decode): returns
    ``(total_samples, sample_rate, channels, bits_per_sample)``, so a
    manifest records an utterance's length without decoding it."""
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as f:
            data = f.read(64)
    else:
        data = bytes(source[:64])
    if data[:4] != b"fLaC" or len(data) < 42:
        raise FlacError("not a FLAC stream")
    # The first metadata block is STREAMINFO by spec.
    if (data[4] & 0x7F) != 0:
        raise FlacError("first metadata block is not STREAMINFO")
    br = _BitReader(data, 8)
    br.read(16); br.read(16); br.read(24); br.read(24)
    rate = br.read(20)
    channels = br.read(3) + 1
    bps = br.read(5) + 1
    total = br.read(36)
    return total, rate, channels, bps


def decode_flac(source, *, force_python: bool = False) -> Tuple[np.ndarray, int, int]:
    """Decode a FLAC file (path or bytes) with the native decoder, or with
    ``decode_flac_py`` when ``force_python`` is set.

    Returns ``(samples[int32, (n, channels)], sample_rate, bits_per_sample)``.
    """
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as f:
            data = f.read()
    else:
        data = bytes(source)
    if force_python:
        return decode_flac_py(data)
    if data[:4] != b"fLaC" or len(data) < 42:
        raise FlacError("not a FLAC stream")
    # STREAMINFO's sample count sizes the output buffer.
    br = _BitReader(data, 8)
    br.read(16); br.read(16); br.read(24); br.read(24); br.read(20)
    channels = br.read(3) + 1
    br.read(5)
    total = br.read(36)
    if total == 0:
        return decode_flac_py(data)
    lib = native.library("flacdec")
    buf = np.empty(total * channels, np.int32)
    arr = np.frombuffer(data, np.uint8)
    rate, nchan, bps = ctypes.c_int32(0), ctypes.c_int32(0), ctypes.c_int32(0)
    native.count("flac_decode")
    n = lib.flac_decode(arr.ctypes.data_as(native.U8P), len(data),
                        buf.ctypes.data_as(native.I32P), total,
                        ctypes.byref(rate), ctypes.byref(nchan), ctypes.byref(bps))
    if n < 0:
        raise FlacError(f"native FLAC decode failed (code {n})")
    return buf[:n * nchan.value].reshape(n, nchan.value).copy(), rate.value, bps.value


# ---------------------------------------------------------------------------
# Encoder (fixture writer)
# ---------------------------------------------------------------------------

def _write_utf8_number(bw: _BitWriter, v: int):
    if v < 0x80:
        bw.write(v, 8)
        return
    payload = []
    nbytes = 2
    while v >= (1 << (6 * (nbytes - 1) + (7 - nbytes))):
        nbytes += 1
    for _ in range(nbytes - 1):
        payload.append(0x80 | (v & 0x3F))
        v >>= 6
    lead = ((0xFF << (8 - nbytes)) & 0xFF) | v
    bw.write(lead, 8)
    for b in reversed(payload):
        bw.write(b, 8)


def _best_rice_param(resid: np.ndarray, plen: int) -> int:
    if len(resid) == 0:
        return 0
    mean = float(np.mean(np.abs(resid.astype(np.float64)))) + 1e-9
    p = max(0, int(np.ceil(np.log2(mean + 1))))
    return min(p, (1 << plen) - 2)


def _write_residual(bw: _BitWriter, resid: np.ndarray, porder: int,
                    blocksize: int, order: int):
    bw.write(0, 2)                  # method 0: 4-bit rice
    bw.write(porder, 4)
    nparts = 1 << porder
    part = blocksize >> porder
    off = 0
    for p in range(nparts):
        count = part - order if p == 0 else part
        chunk = resid[off:off + count]
        off += count
        param = _best_rice_param(chunk, 4)
        # escape to raw if rice would explode (very noisy partitions)
        zig = (np.abs(chunk.astype(np.int64)) << 1) - (chunk < 0)
        rice_bits = int(np.sum(zig >> param)) + count * (1 + param)
        raw_bits = 0
        if len(chunk):
            raw_bits = int(np.max(np.abs(chunk.astype(np.int64)))).bit_length() + 1
        if raw_bits and raw_bits * count + 5 < rice_bits:
            bw.write(15, 4)         # escape
            bw.write(raw_bits, 5)
            for r in chunk:
                bw.write_signed(int(r), raw_bits)
        else:
            bw.write(param, 4)
            for r in chunk:
                v = (int(r) << 1) ^ (int(r) >> 63) if int(r) < 0 else int(r) << 1
                # zigzag: (r<<1)^(r>>63) works for negatives via arith shift
                v = (abs(int(r)) << 1) - (1 if int(r) < 0 else 0)
                bw.write_unary(v >> param)
                if param:
                    bw.write(v & ((1 << param) - 1), param)


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bps: int, mode: str):
    x64 = x.astype(np.int64)
    if mode == "constant":
        bw.write(0, 1); bw.write(0, 6); bw.write(0, 1)
        bw.write_signed(int(x64[0]), bps)
        return
    if mode == "verbatim":
        bw.write(0, 1); bw.write(1, 6); bw.write(0, 1)
        for v in x64:
            bw.write_signed(int(v), bps)
        return
    blocksize = len(x64)
    if mode.startswith("fixed"):
        order = int(mode[-1])
        coeffs = np.array(_FIXED_COEFFS[order], np.int64)
        shift = 0
    elif mode == "lpc":
        order = 2
        # crude quantized LPC fit (fixture quality, not rate-optimal)
        prec, shift = 12, 9
        if blocksize > order + 4:
            X = np.stack([x64[order - 1 - j:blocksize - 1 - j]
                          for j in range(order)], axis=1).astype(np.float64)
            y = x64[order:].astype(np.float64)
            try:
                sol, *_ = np.linalg.lstsq(X, y, rcond=None)
            except np.linalg.LinAlgError:
                sol = np.zeros(order)
        else:
            sol = np.zeros(order)
        coeffs = np.clip(np.round(sol * (1 << shift)),
                         -(1 << (prec - 1)), (1 << (prec - 1)) - 1
                         ).astype(np.int64)
    else:
        raise ValueError(mode)

    # residuals
    if order:
        hist = np.stack([x64[order - 1 - j:blocksize - 1 - j]
                         for j in range(order)], axis=1)
        pred = (hist @ coeffs) >> shift if mode == "lpc" else hist @ coeffs
        resid = x64[order:] - pred
    else:
        resid = x64.copy()

    porder = 0
    for cand in (2, 1, 0):
        if blocksize % (1 << cand) == 0 and (blocksize >> cand) > order:
            porder = cand
            break

    if mode.startswith("fixed"):
        bw.write(0, 1); bw.write(8 + order, 6); bw.write(0, 1)
        for v in x64[:order]:
            bw.write_signed(int(v), bps)
    else:
        bw.write(0, 1); bw.write(32 + (order - 1), 6); bw.write(0, 1)
        for v in x64[:order]:
            bw.write_signed(int(v), bps)
        bw.write(prec - 1, 4)
        bw.write_signed(shift, 5)
        for c in coeffs:
            bw.write_signed(int(c), prec)
    _write_residual(bw, resid, porder, blocksize, order)


def write_flac(
    path: str,
    samples: np.ndarray,
    sample_rate: int = 16000,
    *,
    bps: int = 16,
    block_size: int = 4096,
    subframe_mode: str = "auto",
) -> None:
    """Encode int PCM ``samples`` ([n] mono or [n, channels]) to a FLAC
    file. ``subframe_mode``: 'auto' (fixed-2 / lpc / constant per block),
    or force 'constant'|'verbatim'|'fixed0'..'fixed4'|'lpc'."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    n, channels = x.shape
    lo, hi = -(1 << (bps - 1)), (1 << (bps - 1)) - 1
    if x.min() < lo or x.max() > hi:
        raise FlacError(f"samples exceed {bps}-bit range")

    out = bytearray()
    out += b"fLaC"
    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    body = si.getvalue() + b"\x00" * 16          # MD5 unset (all zero)
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    rate_code = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5,
                 22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10,
                 96000: 11}.get(sample_rate)

    frame_idx = 0
    for start in range(0, n, block_size):
        blk = x[start:start + block_size]
        blocksize = len(blk)
        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)
        bw.write(0, 1)                  # fixed blocking strategy
        if blocksize == block_size and blocksize in {v: k for k, v in
                                                     _BLOCKSIZE_CODE.items()}:
            bw.write({v: k for k, v in _BLOCKSIZE_CODE.items()}[blocksize], 4)
            bs_extra = None
        elif blocksize <= 256:
            bw.write(6, 4)
            bs_extra = (blocksize - 1, 8)
        else:
            bw.write(7, 4)
            bs_extra = (blocksize - 1, 16)
        if rate_code is not None:
            bw.write(rate_code, 4)
            sr_extra = None
        else:
            bw.write(14, 4)             # rate in Hz/10, 16 bits
            sr_extra = (sample_rate // 10, 16)
        bw.write(channels - 1, 4)       # independent channels
        bw.write({8: 1, 12: 2, 16: 4, 20: 5, 24: 6}[bps], 3)
        bw.write(0, 1)
        _write_utf8_number(bw, frame_idx)
        if bs_extra:
            bw.write(*bs_extra)
        if sr_extra:
            bw.write(*sr_extra)
        hdr = bw.getvalue()
        bw2 = _BitWriter()
        for c in range(channels):
            ch = blk[:, c]
            mode = subframe_mode
            if mode == "auto":
                if blocksize < 8:
                    mode = "verbatim"
                elif np.all(ch == ch[0]):
                    mode = "constant"
                elif frame_idx % 2 == 0:
                    mode = "fixed2"
                else:
                    mode = "lpc"
            if mode in ("fixed2", "lpc") and blocksize < 8:
                mode = "verbatim"
            _encode_subframe(bw2, ch, bps, mode)
        bw2.align()
        frame_body = hdr + bytes([_crc8(hdr)]) + bw2.getvalue()
        out += frame_body + _crc16(frame_body).to_bytes(2, "big")
        frame_idx += 1

    with open(path, "wb") as f:
        f.write(bytes(out))
