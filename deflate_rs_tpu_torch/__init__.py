"""deflate_rs_tpu_torch — the DEFLATE/zlib/gzip encoder on PyTorch and CUDA.

The port of ``deflate_rs_tpu`` (the JAX/Pallas package beside it, which
stays the reference) to PyTorch, with hand-written CUDA kernels for an
NVIDIA Hopper card in place of its Pallas kernels.  Output is byte-identical
to the reference.  This package imports ``torch`` and never ``jax``.

Ported so far: the one-shot API at every preset (Default, high, fast, rle,
huffman_only, turbo) and both force modes; the streaming encoders
(``write.DeflateEncoder``, ``write.ZlibEncoder``, ``write.gzip.GzEncoder``);
the batched corpus engine (``parallel.corpus.compress_corpus`` and its zlib
and gzip forms, every chunk size the JAX package encodes up to 1 MiB) with
its used-prefix compaction;
the device checksums (``ops.checksum``); both decoders, the host oracle
(``inflate``, ``inflate_zlib``, ``inflate_gzip``) and the device validator
(``ops.inflate_device.inflate_device``); and the multi-GPU sharded encoder
on ``torch.distributed`` (``parallel.mesh``, ``parallel.sharded``).  Not
yet: the bench.  Every entry that touches a device takes ``device``
(default ``"cuda"``).
"""

from .compression_options import (
    Compression,
    CompressionOptions,
    MatchingType,
    SpecialOptions,
    options_from_reference,
)
from .models.deflate import (
    deflate_bytes,
    deflate_bytes_conf,
    deflate_bytes_gzip,
    deflate_bytes_gzip_conf,
    deflate_bytes_zlib,
    deflate_bytes_zlib_conf,
)
from .models.gzip_header import GzBuilder
from .models.inflate import inflate, inflate_gzip, inflate_zlib
from . import write

__all__ = [
    "Compression",
    "CompressionOptions",
    "MatchingType",
    "SpecialOptions",
    "GzBuilder",
    "options_from_reference",
    "deflate_bytes",
    "deflate_bytes_conf",
    "deflate_bytes_zlib",
    "deflate_bytes_zlib_conf",
    "deflate_bytes_gzip",
    "deflate_bytes_gzip_conf",
    "inflate",
    "inflate_zlib",
    "inflate_gzip",
    "write",
]
