"""Streaming encoders, namespaced like the reference's ``deflate::write``
module (writer.rs): ``write::DeflateEncoder``, ``write::ZlibEncoder``, and the
gzip feature's ``write::gzip::GzEncoder``.
"""

from .models.streaming import DeflateEncoder, GzEncoder, ZlibEncoder


class gzip:  # namespace mirroring deflate::write::gzip
    GzEncoder = GzEncoder


__all__ = ["DeflateEncoder", "ZlibEncoder", "GzEncoder", "gzip"]
