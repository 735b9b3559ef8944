"""The port's native host runtime is built from the port's own source.

``deflate_rs_tpu_torch/runtime/native.py`` compiles
``deflate_rs_tpu_torch/csrc/deflate_runtime.cpp`` (its own copy of the
plain-C ABI the JAX package binds) into the port's build directory; nothing
it builds comes from outside the package.  Tolerance: exact equality.
"""

import ctypes
import os
import subprocess
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deflate_rs_tpu_torch.runtime import native  # noqa: E402

PKG = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
DATA = np.random.default_rng(5).integers(0, 256, 100_003, dtype=np.uint8).tobytes()


def test_runtime_source_lies_in_the_package():
    assert native.SRC == os.path.join(PKG, "csrc", "deflate_runtime.cpp")
    assert os.path.isfile(native.SRC)
    assert os.path.dirname(native.LIB_PATH) == native.BUILD_DIR
    assert os.path.commonpath([native.BUILD_DIR, PKG]) == PKG


def test_loaded_library_is_built_from_the_package_source():
    assert native.available(), "native runtime failed to build: check g++"
    assert os.path.getmtime(native.LIB_PATH) >= os.path.getmtime(native.SRC)
    assert native.crc32(DATA) == zlib.crc32(DATA)
    assert native.adler32(DATA) == zlib.adler32(DATA)


def test_package_source_alone_builds_the_runtime(tmp_path):
    """The source compiles on its own into a library whose checksums and
    chunk assembly are right."""
    lib_path = tmp_path / "libdeflate_runtime.so"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(lib_path), native.SRC],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.crc32_raw.restype = lib.adler32.restype = ctypes.c_uint32
    lib.crc32_raw.argtypes = lib.adler32.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                                     ctypes.c_uint32]
    assert lib.crc32_raw(DATA, len(DATA), 0xFFFFFFFF) ^ 0xFFFFFFFF == zlib.crc32(DATA)
    assert lib.adler32(DATA, len(DATA), 1) == zlib.adler32(DATA)
    words = np.frombuffer(DATA[:3000], np.uint8).reshape(3, 1000)
    nbytes = np.array([10, 0, 999], np.int64)
    out = np.empty(int(nbytes.sum()), np.uint8)
    lib.assemble_chunks.restype = ctypes.c_int64
    lib.assemble_chunks.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_void_p, ctypes.c_int64]
    assert lib.assemble_chunks(out.ctypes.data, words.ctypes.data, 1000,
                               nbytes.ctypes.data, 3) == 0
    assert out.tobytes() == DATA[:10] + DATA[2000:2999]
