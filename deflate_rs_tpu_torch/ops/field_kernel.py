"""Token bit fields per position: CUDA kernel + plain twin.

Replaces the Pallas kernel ``deflate_rs_tpu/ops/field_kernel.py::_kernel``
(entry ``token_fields_batched``).  For each (chunk, quarter), every
position's litlen symbol and distance code are looked up in the owning
block's packed ``code | len << 16`` tables (288 and 30 entries) and turned
into two fields: t1 = litlen code with the length extra bits above it, t2 =
distance code with the distance extra bits above it, each with its width.
Values follow uint32 shift semantics and are returned as int32 bit patterns.

The rules are the Pallas kernel's, element for element, on any int32 input.
A position is a litlen token where ``lsym < 288`` and a match token where
``dcode < 30``, in a chunk with ``huff`` set: the encoder's sentinels (999,
99) are not, and negative symbols are.  A symbol outside ``[0, nsym)`` looks
up 0, so a negative token's width is its extra-bit count alone.  A table
entry's width is its high half shifted arithmetically (an entry with bit 31
set has a negative width); a shift by a width outside ``[0, 32)`` gives 0.
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime import cuda

NSYM_L = 288
NSYM_D = 30
TILE_POSITIONS = 512  # positions of a block of the CUDA kernel (kTile)
MAX_TILE_QUARTERS = 38  # quarters whose tables fit a block's 48 KB of shared memory

_KERNEL = cuda.register("token_fields", [
    ctypes.c_void_p,                                                  # huff
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,                # lsym, len_en, len_ev
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,                # dcode, dist_en, dist_ev
    ctypes.c_void_p, ctypes.c_void_p,                                 # l_pack_q, d_pack_q
    ctypes.c_int, ctypes.c_int, ctypes.c_int,                         # B, E, nq
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # t1v t1b t2v t2b
])


def _lookup(tbl_q, sym, nsym: int, nq: int):
    """tbl_q[b, quarter(i), sym[b, i]] with out-of-table symbols -> 0."""
    B, E = sym.shape
    QL = E // nq
    q = torch.arange(E, device=sym.device) // QL
    ok = (sym >= 0) & (sym < nsym)
    flat = q * nsym + sym.clamp(0, nsym - 1).long()
    vals = tbl_q.reshape(B, nq * nsym).long().gather(1, flat)
    return torch.where(ok, vals, 0)


def _shl32(v, s):
    """uint32 ``v << s``: 0 where the shift lies outside [0, 32)."""
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, (v.long() & 0xFFFFFFFF) << s.clamp(0, 31), 0) & 0xFFFFFFFF


def token_fields_plain(huff, lsym, len_en, len_ev, dcode, dist_en, dist_ev,
                       l_pack_q, d_pack_q):
    """Plain PyTorch version of :func:`token_fields` (same outputs)."""
    nq = l_pack_q.shape[1]
    on = (huff != 0)[:, None]
    l_pack = _lookup(l_pack_q, lsym, NSYM_L, nq)
    d_pack = _lookup(d_pack_q, dcode, NSYM_D, nq)
    l_len = l_pack >> 16  # the int32 entries sign-extended: an arithmetic shift
    d_len = d_pack >> 16
    t1v = (l_pack & 0xFFFF) | _shl32(len_ev, l_len)
    t2v = (d_pack & 0xFFFF) | _shl32(dist_ev, d_len)
    t1b = torch.where(on & (lsym < NSYM_L), l_len + len_en, 0)
    t2b = torch.where(on & (dcode < NSYM_D), d_len + dist_en, 0)
    # int32 wraps, as the kernels' sums do.
    return t1v.int(), t1b.int(), t2v.int(), t2b.int()


def token_fields(huff, lsym, len_en, len_ev, dcode, dist_en, dist_ev,
                 l_pack_q, d_pack_q):
    """Token field values/widths int32[B, E] x 4 for a batch of chunks.

    Args:
      huff: int32[B], 1 if the chunk emits Huffman tokens, 0 if stored.
      lsym: int32[B, E] litlen symbol, 999 where not a token.
      len_en/len_ev: int32[B, E] length extra-bit count/value.
      dcode: int32[B, E] distance code, 99 where not a match token.
      dist_en/dist_ev: int32[B, E] distance extra-bit count/value.
      l_pack_q: int32[B, nq, 288], d_pack_q: int32[B, nq, 30] packed
        ``code | len << 16`` tables of each quarter's block.

    Returns (t1v, t1b, t2v, t2b).  On a CUDA tensor the kernel takes any
    contiguous operands: 16-byte loads where every row is 16-byte aligned,
    scalar loads otherwise.  It raises where a tile of ``TILE_POSITIONS``
    touches more than ``MAX_TILE_QUARTERS`` quarters (quarters of about 14
    positions, which no preset makes).
    """
    if not lsym.is_cuda:
        return token_fields_plain(huff, lsym, len_en, len_ev, dcode, dist_en,
                                  dist_ev, l_pack_q, d_pack_q)
    B, E = lsym.shape
    nq = l_pack_q.shape[1]
    if E % nq:
        raise ValueError(f"token_fields: E={E} does not divide by nq={nq}")
    if E and min(nq, (TILE_POSITIONS - 1) // (E // nq) + 2) > MAX_TILE_QUARTERS:
        raise ValueError(f"token_fields: quarters of {E // nq} positions are too short for "
                         f"a tile of {TILE_POSITIONS}")
    cuda.check_cuda(huff, "huff", torch.int32, (B,))
    for name, t in (("lsym", lsym), ("len_en", len_en), ("len_ev", len_ev),
                    ("dcode", dcode), ("dist_en", dist_en), ("dist_ev", dist_ev)):
        cuda.check_cuda(t, name, torch.int32, (B, E))
    cuda.check_cuda(l_pack_q, "l_pack_q", torch.int32, (B, nq, NSYM_L))
    cuda.check_cuda(d_pack_q, "d_pack_q", torch.int32, (B, nq, NSYM_D))
    outs = [torch.empty((B, E), dtype=torch.int32, device=lsym.device) for _ in range(4)]
    _KERNEL(lsym.device, huff.data_ptr(), lsym.data_ptr(), len_en.data_ptr(),
            len_ev.data_ptr(), dcode.data_ptr(), dist_en.data_ptr(),
            dist_ev.data_ptr(), l_pack_q.data_ptr(), d_pack_q.data_ptr(),
            B, E, nq, *(o.data_ptr() for o in outs))
    return tuple(outs)
