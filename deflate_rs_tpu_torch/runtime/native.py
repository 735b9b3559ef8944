"""ctypes bindings for the native host runtime (``csrc/deflate_runtime.cpp``).

The port's own copy of the plain-C ABI the JAX package binds
(deflate_rs_tpu/runtime/native.py), built with g++ on first use into the
port's own build directory, so the two packages never race on one library
file and the port builds nothing from outside its package.  Every entry point has a NumPy/stdlib fallback: the native path speeds
up the host-side serial tail (bit splicing, checksums) and is never required
for correctness.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import zlib

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "deflate_runtime.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libdeflate_runtime.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(LIB_PATH) or os.path.getmtime(LIB_PATH) < os.path.getmtime(SRC):
                os.makedirs(BUILD_DIR, exist_ok=True)
                # Private temp path + atomic rename: a concurrent process
                # never dlopens a half-written library.
                tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, SRC],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, LIB_PATH)
            lib = ctypes.CDLL(LIB_PATH)
        except (OSError, subprocess.CalledProcessError):
            _lib = None
            return _lib
        lib.bit_append.restype = ctypes.c_int64
        lib.bit_append.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.assemble_chunks.restype = ctypes.c_int64
        lib.assemble_chunks.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.crc32_raw.restype = ctypes.c_uint32
        lib.crc32_raw.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32]
        lib.adler32.restype = ctypes.c_uint32
        lib.adler32.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the host runtime was built and loaded."""
    return _load() is not None


def assemble_chunks(words: np.ndarray, nbytes: np.ndarray) -> bytes:
    """Concatenate per-chunk payloads.  words: uint8[n_chunks, stride]."""
    lib = _load()
    if words.dtype != np.uint8 or words.ndim != 2:
        # The C side measures the stride in bytes: a 32-bit view passed by
        # mistake would be read at a quarter of the real stride.
        raise TypeError(f"words must be uint8[n_chunks, stride], got {words.dtype}{words.shape}")
    nbytes = np.ascontiguousarray(nbytes, np.int64)
    if nbytes.shape != (words.shape[0],):
        raise ValueError(f"nbytes shape {nbytes.shape} != ({words.shape[0]},)")
    if nbytes.size and (int(nbytes.max()) > words.shape[1] or int(nbytes.min()) < 0):
        raise ValueError(
            f"chunk byte count out of range for stride {words.shape[1]}: "
            f"{int(nbytes.min())}..{int(nbytes.max())}")
    if lib is None:
        return b"".join(words[i, : int(nbytes[i])].tobytes() for i in range(words.shape[0]))
    out = np.empty(int(nbytes.sum()), np.uint8)
    words = np.ascontiguousarray(words)
    rc = lib.assemble_chunks(out.ctypes.data, words.ctypes.data, words.shape[1],
                             nbytes.ctypes.data, words.shape[0])
    if rc != 0:
        raise ValueError("assemble_chunks: chunk byte count out of range (native)")
    return out.tobytes()


def bit_append(dst: bytearray, dst_bits: int, src: bytes, src_bits: int) -> int:
    """Append src's bit string onto dst (LSB-first); returns new bit length.

    dst must be pre-sized to hold the result plus one spare byte.
    """
    lib = _load()
    if lib is not None:
        buf = (ctypes.c_char * len(dst)).from_buffer(dst)
        return int(lib.bit_append(buf, dst_bits, src, src_bits))
    shift = dst_bits & 7
    pos = dst_bits >> 3
    nsrc = (src_bits + 7) >> 3
    if shift == 0:
        dst[pos : pos + nsrc] = src[:nsrc]
    else:
        s = np.frombuffer(src, np.uint8, nsrc).astype(np.uint16) << shift
        s[0] |= dst[pos] & ((1 << shift) - 1)
        out = (s & 0xFF).astype(np.uint8)
        out[1:] |= (s[:-1] >> 8).astype(np.uint8)
        dst[pos : pos + nsrc] = out.tobytes()
        dst[pos + nsrc] = int(s[-1] >> 8)
    return dst_bits + src_bits


def crc32(data: bytes, value: int = 0) -> int:
    lib = _load()
    if lib is None:
        return zlib.crc32(data, value)
    return int(lib.crc32_raw(data, len(data), value ^ 0xFFFFFFFF)) ^ 0xFFFFFFFF


def adler32(data: bytes, value: int = 1) -> int:
    lib = _load()
    if lib is None:
        return zlib.adler32(data, value)
    return int(lib.adler32(data, len(data), value))
