"""The long-range dominant-distance measurement: CUDA kernel + plain twin.

Replaces the Pallas kernel ``deflate_rs_tpu/ops/lr_kernel.py::_kernel``
(launched by ``lr_measure_batched``, wrapped by
``longrange.local_dominant_lengths_tpu``).  For each chunk, segment ``s`` and
live dominant distance ``d``, every word ``w`` of the segment's window
(``LW`` words: the ``L/4`` owned words plus the MAX_MATCH overhang) is
compared with the word ``d`` bytes back: ``x = P[s*L + 4w] ^ P[s*L + 4w - d]``
where ``P[i]`` packs bytes ``i..i+3`` little-endian (bytes outside the
buffer read as zero).  The run from each word start is
``4 * (full words up to the first mismatching word) + its matched low
bytes``, exact within the window.  Per word the first dominant with the
longest run wins; the outputs are its run, its distance, and the XOR of word
``w`` under the distance that wins word ``w + 1``.

This is exactly the word-space measurement of the JAX package's
``longrange.local_dominant_lengths``, and at one segment holding the chunk's
unioned distances (S = 1, M = D) that of ``global_dominant_lengths``;
:func:`lr_measure_plain` is that computation in PyTorch, and
:func:`lr_measure` runs the CUDA kernel (``csrc/lr_measure.cu``) on a CUDA
tensor and the plain version on a CPU one.  The kernel has two paths, chosen
from the geometry: one block a segment where the window fits a block's shared
memory and the winner key has room for the slot (the presets' local pass),
else the tiled path (the whole-chunk window of ``lr_global``, or more than
64 slots): three launches, counted as one call of ``lr_measure_tiled``, over
tiles of ``TILE_WORDS`` words and groups of 8 to 32 live slots, whose
winners meet in keys of :func:`tiled_key_bits`.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import MAX_MATCH, WINDOW_SIZE
from ..runtime import cuda
from .matching import matched_low_bytes

_KERNEL = cuda.register("lr_measure", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,       # buf, buf_len, doms
    ctypes.c_int, ctypes.c_int, ctypes.c_int,             # B, S, M
    ctypes.c_int, ctypes.c_int,                           # L, LW
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,    # run, dist, xor_next
])

_TILED = cuda.register("lr_measure_tiled", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,       # buf, buf_len, doms
    ctypes.c_int, ctypes.c_int, ctypes.c_int,             # B, S, M
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,          # L, LW, scratch
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,    # run, dist, xor_next
])

# The block path's limits; the tiled path takes anything beyond them.
MAX_SLOTS = 64  # dominants per segment its winner key has room for
MAX_WINDOW_WORDS = 5632  # words per segment a block's shared memory holds
TILE_WORDS = 1024  # words of a tile of the tiled path (kTile)


def tiled_key_bits(LW: int, M: int) -> tuple:
    """(sb, bytes) of the tiled path's winner keys ``(run + 1) << sb |
    (2^sb - 1 - slot)``: sb the fewest bits that hold a slot index, in 4
    bytes where ``(4 LW + 1) << sb`` fits 32 bits (a run is at most 4 LW),
    else sb = 32 in 8 bytes."""
    sb = max(1, (M - 1).bit_length())
    return (sb, 4) if (4 * LW + 1) << sb < 1 << 32 else (32, 8)


def tiled_scratch_words(B: int, S: int, M: int, LW: int) -> int:
    """int32 words of the tiled path's scratch: the first mismatches
    [B, S, M, tiles], padded to 8 bytes, then room for 64-bit keys [B, S, LW]."""
    nfirst = B * S * M * -(-LW // TILE_WORDS)
    return nfirst + nfirst % 2 + 2 * B * S * LW


def window_words(N: int, S: int) -> int:
    """LW: words measured per segment (owned words + MAX_MATCH overhang)."""
    return (N // S + MAX_MATCH + 6) // 4 + 1


def lr_measure_plain(buf: torch.Tensor, doms: torch.Tensor, N: int):
    """Plain PyTorch version of :func:`lr_measure` (same outputs)."""
    B, S, M = doms.shape
    L = N // S
    LW = window_words(N, S)
    dev = buf.device
    d8 = torch.nn.functional.pad(buf.long(), (WINDOW_SIZE, 4 * LW + 8))
    P = d8[:, :-3] | (d8[:, 1:-2] << 8) | (d8[:, 2:-1] << 16) | (d8[:, 3:] << 24)
    wi = torch.arange(LW, device=dev)
    start = WINDOW_SIZE + torch.arange(S, device=dev)[:, None] * L + 4 * wi  # [S, LW]
    base = P[:, start]  # [B, S, LW]
    off = start[None, :, None, :] - doms.long()[..., None]  # [B, S, M, LW]
    sh = P.gather(1, off.reshape(B, -1)).reshape(B, S, M, LW)
    x = base[:, :, None, :] ^ sh
    pval = torch.where(x == 0, LW * 8, wi * 8 + matched_low_bytes(x))
    pmin = torch.cummin(pval.flip(-1), dim=-1).values.flip(-1)
    run0 = 4 * ((pmin >> 3) - wi) + (pmin & 7)
    run0 = torch.where((doms > 0)[..., None], run0, -1)
    # argmax takes the FIRST maximum, as jnp.argmax does.
    run_w, win = run0.max(dim=2).values, run0.argmax(dim=2)
    dist_w = doms.long().gather(2, win)
    # XOR of word w at the dominant that wins word w + 1 (0 past the window).
    win_n = torch.nn.functional.pad(win[..., 1:], (0, 1))
    xor_next = x.gather(2, win_n[:, :, None, :]).squeeze(2)
    xor_next[..., -1] = 0
    return run_w.int(), dist_w.int(), xor_next


def lr_measure_plain_sliced(buf: torch.Tensor, doms: torch.Tensor, N: int, step: int):
    """:func:`lr_measure_plain` over ``step`` slots at a time (its [B, S, M,
    LW] temporaries grow with M): a slice wins a word where its run is longer
    than every earlier slice's, and word w's XOR follows the slice that wins
    word w + 1."""
    parts = (lr_measure_plain(buf, doms[..., i : i + step].contiguous(), N)
             for i in range(0, doms.shape[-1], step))
    run, dist, xn = next(parts)
    for r, d, x in parts:
        better = r > run
        run, dist = torch.where(better, r, run), torch.where(better, d, dist)
        xn = torch.where(torch.nn.functional.pad(better[..., 1:], (0, 1)), x, xn)
    return run, dist, xn


def lr_measure(buf: torch.Tensor, doms: torch.Tensor, N: int):
    """Per-segment-word winner of the dominant-distance measurement.

    Args:
      buf: uint8[B, N + PAD] chunk buffers.
      doms: int32[B, S, M] dominant distances per segment, 0 = dead slot.
      N: positions per chunk (divisible by 4 * S).

    Returns (run, dist, xor_next): int32, int32, int64 [B, S, LW].
    """
    if not buf.is_cuda:
        return lr_measure_plain(buf, doms, N)
    B, S, M = doms.shape
    L = N // S
    LW = window_words(N, S)
    if N % (4 * S) or M < 1:
        raise ValueError(f"lr_measure: unsupported geometry N={N}, S={S}, M={M}")
    cuda.check_cuda(buf, "buf", torch.uint8, (B, buf.shape[1]))
    cuda.check_cuda(doms, "doms", torch.int32, (B, S, M))
    run = torch.empty((B, S, LW), dtype=torch.int32, device=buf.device)
    dist = torch.empty_like(run)
    xn = torch.empty((B, S, LW), dtype=torch.int64, device=buf.device)
    if LW <= MAX_WINDOW_WORDS and M <= MAX_SLOTS:
        _KERNEL(buf.device, buf.data_ptr(), buf.shape[1], doms.data_ptr(), B, S, M,
                L, LW, run.data_ptr(), dist.data_ptr(), xn.data_ptr())
    else:
        scratch = torch.empty(tiled_scratch_words(B, S, M, LW), dtype=torch.int32,
                              device=buf.device)
        _TILED(buf.device, buf.data_ptr(), buf.shape[1], doms.data_ptr(), B, S, M, L, LW,
               scratch.data_ptr(), run.data_ptr(), dist.data_ptr(), xn.data_ptr())
    return run, dist, xn
