"""Host-side bit-level stream assembly (packed, marker-free concatenation).

Port of ``deflate_rs_tpu/models/assembly.py``: chunk bitstreams are spliced
at arbitrary bit phase with the native ``bit_append``
(csrc/deflate_runtime.cpp), and stored chunks are re-emitted from the raw
payload because their byte-alignment pad depends on the phase
(stored_block.rs:13-40).  The streaming encoders keep one assembler per
stream and drain its whole bytes after every write.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..runtime import native


class BitAssembler:
    """An LSB-first bit sink backed by the native bit splicer.

    Invariant (required by ``bit_append``): all bits beyond ``self.bits`` in
    the buffer are zero.
    """

    def __init__(self, capacity_bytes: int = 1 << 16):
        self.buf = bytearray(capacity_bytes + 8)
        self.bits = 0

    def _ensure(self, extra_bits: int):
        need = (self.bits + extra_bits) // 8 + 8
        if need > len(self.buf):
            self.buf.extend(bytes(max(need - len(self.buf), len(self.buf))))

    def append(self, data: bytes, nbits: int):
        """Splice ``nbits`` bits of ``data`` (bits above nbits must be 0)."""
        if nbits == 0:
            return
        self._ensure(nbits)
        self.bits = native.bit_append(self.buf, self.bits, bytes(data), nbits)

    def align_byte(self):
        """Zero-pad to the next byte boundary (buffer is already zero there)."""
        self.bits = (self.bits + 7) & ~7

    def append_stored_chunk(self, payload: bytes, is_last: bool):
        """Emit ``payload`` as stored sub-blocks at the current phase."""
        n = len(payload)
        sb = C.MAX_STORED_BLOCK
        n_sub = max(1, (n + sb - 1) // sb)
        for k in range(n_sub):
            part = payload[k * sb : (k + 1) * sb]
            final = is_last and k == n_sub - 1
            self._ensure(43 + 8 * len(part))
            self.append(bytes([1 if final else 0]), 3)  # BFINAL | (00 << 1)
            self.align_byte()
            ln = len(part)
            hdr = bytes([ln & 0xFF, ln >> 8, ~ln & 0xFF, (~ln >> 8) & 0xFF])
            self.append(hdr + part, 8 * (4 + ln))

    def append_sync_marker(self):
        """Empty stored block: byte-aligns the stream (compress.rs:257-262)."""
        self._ensure(48)
        self.append(b"\x00", 3)
        self.align_byte()
        self.append(b"\x00\x00\xff\xff", 32)

    def drain_whole_bytes(self) -> bytes:
        """Return all complete bytes, keeping the partial tail byte."""
        full = self.bits >> 3
        out = bytes(self.buf[:full])
        tail = self.buf[full] if self.bits & 7 else 0
        # Everything above self.bits is zero by the class invariant, so
        # zeroing the drained prefix restores it at a cost proportional to
        # the drain, not to the capacity.
        self.buf[: full + 1] = bytes(full + 1)
        self.buf[0] = tail
        self.bits &= 7
        return out

    def take_aligned(self) -> bytes:
        """Pad to a byte boundary and return the whole stream."""
        self.align_byte()
        return bytes(self.buf[: self.bits >> 3])

    def take_aligned_drain(self) -> bytes:
        """Pad to a byte boundary, return all remaining bytes, and reset."""
        out = self.take_aligned()
        self.buf[: len(self.buf)] = bytes(len(self.buf))
        self.bits = 0
        return out


def splice_encoded_chunk(asm: BitAssembler, btype: int, data_bits: int,
                         words: np.ndarray, payload: bytes, is_last: bool) -> int:
    """Append one encoded chunk to ``asm`` at the current bit phase.

    ``words`` holds the chunk's packed little-endian 32-bit words (any
    integer dtype holding the unsigned values or their int32 pattern), or
    the same words as a ``uint8`` view (the compacted fetch).  Huffman blocks
    splice their first ``data_bits`` bits; stored blocks are re-emitted from
    ``payload``.  Returns the number of bits appended.
    """
    if btype == C.BTYPE_STORED:
        before = asm.bits
        asm.append_stored_chunk(payload, is_last)
        return asm.bits - before
    w = np.asarray(words)
    if w.dtype != np.uint8:
        w = w.astype("<u4").view(np.uint8)
    asm.append(w.tobytes()[: (data_bits + 7) // 8], data_bits)
    return data_bits
