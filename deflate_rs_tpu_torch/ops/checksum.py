"""Parallel, combinable Adler-32 and CRC-32.

Port of ``deflate_rs_tpu/ops/checksum.py``.  The reference updates both
checksums serially over the whole input (checksum.rs:33-57; writer.rs:410-426);
here both are reductions over a batch of chunks:

* **Adler-32** is two modular sums, ``s1 = sum b_i`` and
  ``s2 = sum (n - i) * b_i``, taken in int64 (the JAX package splits the
  weights to stay inside int32; the residues mod 65521 are the same).

* **CRC-32** is linear over GF(2): the register after a message with a zero
  initial register (the "raw CRC") satisfies
  ``raw(A || B) = shift(raw(A), len(B)) ^ raw(B)`` with ``shift`` a constant
  32 x 32 matrix per length.  Every byte goes through the standard table (one
  gather), and a log-depth tree combines neighbours; the level's shift matrix
  is applied by four gathers from its byte tables.

Per-chunk results are combined across chunks and devices by the same
identities on the host (:func:`adler32_combine`, :func:`crc32_combine_raw`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import ADLER_MOD, CRC32_POLY

# ---------------------------------------------------------------------------
# CRC-32 host-side constants
# ---------------------------------------------------------------------------


def _build_crc_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (CRC32_POLY if (c & 1) else 0)
        table[b] = c
    return table


CRC_TABLE = _build_crc_table()


def _gf2_matrix_times(mat: np.ndarray, vec: int) -> int:
    """Apply a GF(2) 32x32 matrix (array of 32 uint32 columns) to a 32-bit vector."""
    out = 0
    j = 0
    while vec:
        if vec & 1:
            out ^= int(mat[j])
        vec >>= 1
        j += 1
    return out


def _gf2_matrix_square(mat: np.ndarray) -> np.ndarray:
    return np.array([_gf2_matrix_times(mat, int(c)) for c in mat], dtype=np.uint32)


def _build_byte_shift_matrix() -> np.ndarray:
    """Matrix for advancing a raw CRC register past one zero byte:
    c' = (c >> 8) ^ TABLE[c & 0xFF]."""
    cols = np.zeros(32, dtype=np.uint32)
    for j in range(32):
        c = 1 << j
        cols[j] = (c >> 8) ^ CRC_TABLE[c & 0xFF]
    return cols


# SHIFT_MATRICES[k] advances a raw CRC past 2**k zero bytes.
_MAX_SHIFT_LOG2 = 48
SHIFT_MATRICES = [_build_byte_shift_matrix()]
for _ in range(_MAX_SHIFT_LOG2 - 1):
    SHIFT_MATRICES.append(_gf2_matrix_square(SHIFT_MATRICES[-1]))


def crc_shift(crc: int, num_bytes: int) -> int:
    """Advance a raw CRC register past ``num_bytes`` zero bytes (host side)."""
    k = 0
    while num_bytes:
        if num_bytes & 1:
            crc = _gf2_matrix_times(SHIFT_MATRICES[k], crc)
        num_bytes >>= 1
        k += 1
    return crc


def crc32_from_raw(raw: int, length: int) -> int:
    """Standard CRC-32 (init 0xFFFFFFFF, final xor) from a raw CRC of the data."""
    return crc_shift(0xFFFFFFFF, length) ^ raw ^ 0xFFFFFFFF


def crc32_combine_raw(raw_a: int, raw_b: int, len_b: int) -> int:
    """raw CRC of the concatenation A||B from raw CRCs of the parts."""
    return crc_shift(raw_a, len_b) ^ raw_b


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------


def shift_byte_tables(num_bytes: int) -> np.ndarray:
    """int64[levels, 4, 256] for buffers of up to ``num_bytes`` bytes
    (``2**levels >= num_bytes``): entry ``[k, j, v]`` is ``SHIFT_MATRICES[k]``
    applied to ``v << 8 * j``, so a register is shifted past ``2**k`` zero
    bytes by XOR-ing four looked-up values."""
    levels = max(1, (num_bytes - 1).bit_length())
    out = np.zeros((levels, 4, 256), np.int64)
    v = np.arange(256)
    for k in range(levels):
        cols = SHIFT_MATRICES[k].astype(np.int64)
        for j in range(4):
            acc = np.zeros(256, np.int64)
            for bit in range(8):
                acc ^= np.where((v >> bit) & 1, cols[8 * j + bit], 0)
            out[k, j] = acc
    return out


def crc32_raw_device(data: torch.Tensor, n: torch.Tensor, crc_table: torch.Tensor,
                     shift_tables: torch.Tensor) -> torch.Tensor:
    """Raw CRC (zero-init register, no final xor) of each ``data[b, :n[b]]``.

    Args:
      data: uint8[B, P]; bytes at index >= n are ignored.
      n: int[B] valid lengths.
      crc_table: int64[256], ``CRC_TABLE`` on the device of ``data``.
      shift_tables: int64[levels, 4, 256] of :func:`shift_byte_tables` with
        ``2**levels >= P``.

    Returns int64[B] raw CRCs (uint32 values).
    """
    P = data.shape[1]
    P2 = 1 << (P - 1).bit_length()
    if (1 << shift_tables.shape[0]) < P2:
        raise ValueError(f"shift tables cover {1 << shift_tables.shape[0]} bytes, need {P2}")
    n = n.long().clamp(0, P)[:, None]
    # Leading zero bytes are the identity for a zero-init register: the valid
    # bytes go to the end of a power-of-two buffer.
    idx = torch.arange(P2, device=data.device)
    src = idx - (P2 - n)
    rolled = torch.where(src >= 0, data.gather(1, src.clamp(min=0)), 0)
    x = crc_table[rolled.long()]
    level = 0
    while x.shape[1] > 1:
        left, right = x[:, 0::2], x[:, 1::2]
        t = shift_tables[level]
        x = (t[0][left & 0xFF] ^ t[1][(left >> 8) & 0xFF] ^ t[2][(left >> 16) & 0xFF]
             ^ t[3][left >> 24] ^ right)
        level += 1
    return x[:, 0]


def adler32_parts_device(data: torch.Tensor, n: torch.Tensor):
    """Adler-32 partial sums of each ``data[b, :n[b]]``.

    Returns (s1, s2) int64[B] where, mod 65521:
      s1 = sum b_i,   s2 = sum (n - i) * b_i   (i = 0..n-1)

    For a standalone buffer: A = 1 + s1, B = n + s2 (mod 65521).
    """
    P = data.shape[1]
    idx = torch.arange(P, device=data.device)
    w = (n.long()[:, None] - idx).clamp(min=0)
    b = torch.where(w > 0, data.long(), 0)
    return b.sum(dim=1) % ADLER_MOD, (w * b).sum(dim=1) % ADLER_MOD


# ---------------------------------------------------------------------------
# Host-side combination across chunks / devices
# ---------------------------------------------------------------------------


def adler32_combine(state: tuple[int, int], s1: int, s2: int, length: int) -> tuple[int, int]:
    """Fold one chunk's (s1, s2, length) into a running (A, B) Adler state."""
    a, b = state
    a2 = (a + s1) % ADLER_MOD
    b2 = (b + (length % ADLER_MOD) * a + s2) % ADLER_MOD
    return a2, b2


ADLER_INIT = (1, 0)


def adler32_value(state: tuple[int, int]) -> int:
    a, b = state
    return (b << 16) | a
