"""Longest-match search, batched over chunks.

Port of ``deflate_rs_tpu/ops/matching.py``: the suffix-sort matcher of the
Default and fast presets (``find_matches`` + ``sa_scan_xla``), the hash
matcher of the high preset (``find_matches_hash``), the rle preset's
distance-1 runs (``find_rle_matches``), and the shared ``chain_extend`` /
``stride_extend`` (the reference's hash-chain ``longest_match``,
matching.rs:87).  Every function takes ``[B, ...]`` tensors, one row per
chunk, with ``n_total`` and ``hstart`` as per-row tensors.

Positions are sorted by their first ``4*nkey`` content bytes (big-endian
words, so unsigned word order is byte order), stably, with the position as
the tie-break.  The match length with the neighbour ``k`` rows away in that
order is the running minimum of adjacent-row LCPs, scanned ``K`` rows deep
on both sides plus a log-step tail.  The JAX package's uint32 words are
carried here as int64 (PyTorch has no uint32 shifts); the scan itself runs
in int32.  On the card the scan is one kernel, ``csrc/sa_scan.cu``, that
reads the sorted rows' bytes from the buffers and writes each score at its
position; :func:`sa_scan_plain` is its plain twin.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import MAX_MATCH, WINDOW_SIZE
from ..runtime import cuda
from .hashing import INVALID_KEY, hash3

_M32 = 0xFFFFFFFF

_KERNEL = cuda.register("sa_scan", [
    ctypes.c_void_p, ctypes.c_longlong,                                # buf, its row width
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,                 # perm, hstart, n_total
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, N, K, PW, NKEY
    ctypes.c_void_p, ctypes.c_int,                                     # tail jumps, their count
    ctypes.c_void_p,                                                   # out
])


def pack_words(data: torch.Tensor) -> torch.Tensor:
    """P[..., i] = d[i] | d[i+1]<<8 | d[i+2]<<16 | d[i+3]<<24 as int64."""
    d = data.long()
    return d[..., :-3] | (d[..., 1:-2] << 8) | (d[..., 2:-1] << 16) | (d[..., 3:] << 24)


def matched_low_bytes(x: torch.Tensor) -> torch.Tensor:
    """Number of matching low-order bytes in an XOR'd packed word (0..4)."""
    return (((x & 0xFF) == 0).int() + ((x & 0xFFFF) == 0).int()
            + ((x & 0xFFFFFF) == 0).int() + (x == 0).int())


def matched_high_bytes(x: torch.Tensor) -> torch.Tensor:
    """Number of matching high-order bytes of a 32-bit XOR (``min(clz(x) >> 3, 4)``)."""
    return (((x & 0xFF000000) == 0).int() + ((x & 0xFFFF0000) == 0).int()
            + ((x & 0xFFFFFF00) == 0).int() + (x == 0).int())


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(-1), dim=-1).values.flip(-1)


def stride_extend(best_len, best_dist, limit, strides=(16, 32, 64, 128)):
    """Compose same-distance matches across log-spaced strides (never
    overclaims; lengths stay clipped by each position's own limit)."""
    l, d = best_len, best_dist
    for s in strides:
        l_s = torch.nn.functional.pad(l[:, s:], (0, s))
        d_s = torch.nn.functional.pad(d[:, s:], (0, s))
        ok = (d > 0) & (d_s == d) & (l >= s)
        l = torch.where(ok, torch.maximum(l, s + l_s), l)
    return torch.minimum(l, limit)


def chain_extend(best_len, best_dist, limit, N: int):
    """Extend probe-measured matches along constant-distance runs."""
    idx = torch.arange(N, dtype=torch.int32, device=best_len.device)
    ok = best_len >= 3
    d_prev = torch.nn.functional.pad(best_dist[:, :-1], (1, 0), value=-1)
    bad = ~ok | (best_dist != d_prev)
    first_bad = _rev_cummin(torch.where(bad, idx, N))
    first_bad_after = torch.nn.functional.pad(first_bad[:, 1:], (0, 1), value=N)
    l_chain = torch.minimum(first_bad_after - idx + 2, limit)
    return torch.where(ok, torch.maximum(best_len, l_chain), 0)


def _stable_lex_sort(keys: list) -> torch.Tensor:
    """Permutation sorting rows by ``keys`` (lexicographic, each key an
    unsigned 32-bit value in int64), stable, so ties keep position order.

    Two keys share one int64 sort operand (``(hi - 2^31) * 2^32 + lo``
    orders like the unsigned pair); the groups are sorted stably from the
    last to the first."""
    groups = []
    k = list(keys)
    while len(k) >= 2:
        lo, hi = k.pop(), k.pop()
        groups.append((hi - (1 << 31)) * (1 << 32) + lo)
    if k:
        groups.append(k.pop())
    B, N = keys[0].shape
    perm = torch.arange(N, device=keys[0].device).expand(B, N)
    for g in groups:  # last key group first
        _, order = torch.sort(g.gather(1, perm), dim=1, stable=True)
        perm = perm.gather(1, order)
    return perm


def adjacent_lcp(skeys, spay) -> torch.Tensor:
    """Byte LCP of each sorted row with the row before, int32[B, N] (0 in
    row 0, at most 4 bytes a word): the key words compared from their high
    bytes, then the payload words from their low bytes."""
    NKEY = len(skeys)
    total = None
    for w in range(NKEY):
        a = skeys[w]
        b = torch.cat([(~a[:, :1]) & _M32, a[:, :-1]], dim=1)
        m = matched_high_bytes(a ^ b)
        total = m if total is None else total + torch.where(total == 4 * w, m, 0)
    for w, p in enumerate(spay, start=NKEY):
        b = torch.nn.functional.pad(p[:, :-1], (1, 0))
        total = total + torch.where(total == 4 * w, matched_low_bytes(p ^ b), 0)
    al = total.int()
    al[:, 0] = 0
    return al


def sa_scan_rows(skeys, spos, spay, hstart, n_total, num_checks: int,
                 probe_words: int, tail_jumps: tuple = ()):
    """Suffix-order LCP + K-deep running-min scan (``sa_scan_xla``).

    Returns the packed score ``run << 16 | (WINDOW_SIZE + 1 - dist)`` per
    sorted row, int32[B, N], 0 where the row's owner is not a valid start.
    """
    B, N = spos.shape
    dev = spos.device
    al = adjacent_lcp(skeys, spay)

    # ------------------- K-deep running-min scan, both suffix-order sides
    K = num_checks
    DEEP = K + sum(1 << j for j in tail_jumps)
    hst = hstart.int()[:, None]
    svalid = (spos >= hst) & (spos <= n_total.int()[:, None] - 3)
    zpad = torch.zeros(B, DEEP, dtype=torch.int32, device=dev)
    al_b = torch.cat([zpad, al], dim=1)
    al_f = torch.cat([al, zpad], dim=1)
    pos_b = torch.cat([torch.full_like(zpad, -(1 << 30)), spos], dim=1)
    pos_f = torch.cat([spos, torch.full_like(zpad, 1 << 30)], dim=1)

    def score_at(runb, runf, cb, cf, best):
        db = spos - cb
        df = spos - cf
        okb = (db >= 1) & (db <= WINDOW_SIZE) & (cb >= hst) & (runb >= 3)
        okf = (df >= 1) & (df <= WINDOW_SIZE) & (cf >= hst) & (runf >= 3)
        sb = torch.where(okb, (runb << 16) | (WINDOW_SIZE + 1 - db), 0)
        sf = torch.where(okf, (runf << 16) | (WINDOW_SIZE + 1 - df), 0)
        return torch.maximum(best, torch.maximum(sb, sf))

    runb = torch.full((B, N), 4 * probe_words, dtype=torch.int32, device=dev)
    runf = runb.clone()
    best = torch.zeros((B, N), dtype=torch.int32, device=dev)
    for k in range(1, K + 1):
        runb = torch.minimum(runb, al_b[:, DEEP - k + 1 : DEEP - k + 1 + N])
        runf = torch.minimum(runf, al_f[:, k : k + N])
        best = score_at(runb, runf, pos_b[:, DEEP - k : DEEP - k + N],
                        pos_f[:, k : k + N], best)
    if tail_jumps:
        # ------------------------- log-step tail over the sparse min-table
        # M_j[i] = min(al[i - 2^j + 1 .. i]), built by doubling.
        M = [al]
        for j in range(1, max(tail_jumps) + 1):
            s = 1 << (j - 1)
            prev = M[-1]
            M.append(torch.minimum(prev, torch.nn.functional.pad(prev[:, :-s], (s, 0))))
        k = K
        for j in tail_jumps:
            k2 = k + (1 << j)
            Mb = torch.cat([zpad, M[j]], dim=1)
            Mf = torch.cat([M[j], zpad], dim=1)
            runb = torch.minimum(runb, Mb[:, DEEP - k : DEEP - k + N])
            runf = torch.minimum(runf, Mf[:, k2 : k2 + N])
            best = score_at(runb, runf, pos_b[:, DEEP - k2 : DEEP - k2 + N],
                            pos_f[:, k2 : k2 + N], best)
            k = k2
    return torch.where(svalid, best, 0)


def key_words(buf, N: int, n_total, hstart, nkey: int) -> list:
    """The suffix sort's keys: the first ``4*nkey`` bytes of each position
    as big-endian words (unsigned 32-bit values in int64), all ones where
    the position is no valid match start."""
    idx = torch.arange(N, dtype=torch.int32, device=buf.device)
    nt = n_total.int()[:, None]
    valid = (idx >= hstart.int()[:, None]) & (idx <= nt - 3)
    d = buf.long()
    be = (d[:, :-3] << 24) | (d[:, 1:-2] << 16) | (d[:, 2:-1] << 8) | d[:, 3:]
    return [torch.where(valid, be[:, 4 * w : N + 4 * w], _M32) for w in range(nkey)]


def sa_scan_plain(buf, perm, hstart, n_total, num_checks: int, probe_words: int,
                  nkey: int, tail_jumps: tuple = ()):
    """Plain PyTorch version of :func:`sa_scan` (same output): the sorted
    rows' key and payload words gathered, :func:`sa_scan_rows`, and the
    scores scattered to their positions."""
    N = perm.shape[1]
    packed = pack_words(buf)
    skeys = [k.gather(1, perm) for k in key_words(buf, N, n_total, hstart, nkey)]
    spay = [packed[:, 4 * w : N + 4 * w].gather(1, perm) for w in range(nkey, probe_words)]
    best = sa_scan_rows(skeys, perm.int(), spay, hstart, n_total, num_checks, probe_words,
                        tail_jumps)
    return torch.zeros_like(best).scatter_(1, perm, best)


SA_ROWS = 8192  # sorted rows a block of csrc/sa_scan.cu scores (kRows)
SA_MAX_SMEM = 227 * 1024  # shared memory a block may opt in to on Hopper


def sa_scan_smem(num_checks: int, tail_jumps: tuple) -> int:
    """Shared memory of one block of the kernel (csrc/sa_scan.cu)."""
    deep = num_checks + sum(1 << j for j in tail_jumps)
    span = (SA_ROWS + 2 * deep + 15) & ~15
    tables = bool(tail_jumps) and max(tail_jumps) >= 4
    return 4 * ((SA_ROWS + 2 * num_checks + 15) & ~15) + span * (4 if tables else 1)


def sa_scan(buf, perm, hstart, n_total, num_checks: int, probe_words: int, nkey: int,
            tail_jumps: tuple = ()):
    """Each position's best suffix-order match as the packed score
    ``run << 16 | (WINDOW_SIZE + 1 - dist)``, int32[B, N], 0 where the
    position is no valid match start.

    Args:
      buf: uint8[B, W] chunk buffers, W >= N + 4*probe_words - 1.
      perm: int64[B, N] the positions in the suffix sort's order (the
        stable sort by the ``nkey`` words of :func:`key_words`: the kernel
        relies on rows that share a key lying in position order).
      hstart, n_total: int[B] first valid position / end of valid bytes.
      num_checks: the K of the dense scan; tail_jumps: log2 of the tail's jumps.

    A CUDA ``buf`` launches ``csrc/sa_scan.cu`` (K up to 128, 1 to 18 probe
    words, 1 to 4 key words, up to 16 tail jumps of 2^0 to 2^14 rows that fit
    a block's shared memory, W a multiple of 4); anything else raises.
    """
    if not buf.is_cuda:
        return sa_scan_plain(buf, perm, hstart, n_total, num_checks, probe_words, nkey,
                             tail_jumps)
    B, N = perm.shape
    W = buf.shape[1]
    tail = tuple(int(j) for j in tail_jumps)
    if not 1 <= num_checks <= 128:
        raise ValueError(f"sa_scan: K={num_checks} outside 1..128")
    if not 1 <= probe_words <= 18 or not 1 <= nkey <= min(4, probe_words):
        raise ValueError(f"sa_scan: probe_words={probe_words}, nkey={nkey} not taken")
    if len(tail) > 16 or any(not 0 <= j <= 14 for j in tail) or \
            sa_scan_smem(num_checks, tail) > SA_MAX_SMEM:
        raise ValueError(f"sa_scan: tail_jumps={tail} not taken")
    if W % 4 or W < N + 4 * probe_words - 1 or W + N >= 1 << 31 or not 1 <= B <= 65535:
        raise ValueError(f"sa_scan: buffers [{B}, {W}] for {N} positions not taken")
    cuda.check_cuda(buf, "buf", torch.uint8, (B, W))
    if buf.data_ptr() % 4:
        raise ValueError("sa_scan: buf must be 4-byte aligned")
    cuda.check_cuda(perm, "perm", torch.int64, (B, N))
    hstart = hstart.to(device=buf.device, dtype=torch.int64).contiguous()
    n_total = n_total.to(device=buf.device, dtype=torch.int64).contiguous()
    cuda.check_cuda(hstart, "hstart", torch.int64, (B,))
    cuda.check_cuda(n_total, "n_total", torch.int64, (B,))
    out = torch.empty((B, N), dtype=torch.int32, device=buf.device)
    jumps = (ctypes.c_int * max(1, len(tail)))(*tail)
    _KERNEL(buf.device, buf.data_ptr(), W, perm.data_ptr(), hstart.data_ptr(),
            n_total.data_ptr(), B, N, num_checks, probe_words, nkey, jumps, len(tail),
            out.data_ptr())
    return out


def find_matches(buf, N: int, n_total, hstart, num_checks: int,
                 probe_words: int, nkey: int = 0, tail_jumps: tuple = ()):
    """Best (length, distance) per position of each chunk buffer.

    Args:
      buf: uint8[B, N + PAD] chunk buffers (history + payload + padding).
      N: number of positions.
      n_total, hstart: int[B] end of valid bytes / first valid position.

    Returns (best_len, best_dist): int32[B, N], 0 where no match >= 3.
    """
    idx = torch.arange(N, dtype=torch.int32, device=buf.device)
    limit = (n_total.int()[:, None] - idx).clamp(0, MAX_MATCH)
    NKEY = min(nkey, 4, probe_words) if nkey else min(4, probe_words)
    perm = _stable_lex_sort(key_words(buf, N, n_total, hstart, NKEY))
    score_pos = sa_scan(buf, perm, hstart, n_total, num_checks, probe_words, NKEY, tail_jumps)
    return _extend_scores(score_pos, limit, N)


def _unsort_and_extend(best, perm, limit, N: int):
    """Scores per sorted row -> (best_len, best_dist) per position, chain-
    and stride-extended.  The unsort is an inverse-permutation scatter."""
    return _extend_scores(torch.zeros_like(best).scatter_(1, perm, best), limit, N)


def _extend_scores(score_pos, limit, N: int):
    """Scores per position -> (best_len, best_dist), chain- and
    stride-extended."""
    blen = torch.minimum(score_pos >> 16, limit)
    bdist = torch.where(score_pos > 0, WINDOW_SIZE + 1 - (score_pos & 0xFFFF), 0)

    best_len = stride_extend(chain_extend(blen, bdist, limit, N), bdist, limit)
    good = best_len >= 3
    return torch.where(good, best_len, 0), torch.where(good, bdist, 0)


def probe_schedule(K: int, dense_frac: float = 0.875, growth: float = 0.04) -> list:
    """Chain depths probed by :func:`find_matches_hash` (the JAX package's
    ``_probe_schedule``): the first ``dense_frac`` of the budget walks the
    most recent rows densely, the rest at spacing growing by ``growth``."""
    ks, k = [], 1
    while len(ks) < K:
        ks.append(k)
        k += 1 if len(ks) < int(dense_frac * K) else max(1, int(k * growth))
    return ks


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same bit patterns as int32."""
    return (x - ((x >> 31) << 32)).int()


def find_matches_hash(buf, N: int, n_total, hstart, num_checks: int, probe_words: int):
    """Best (length, distance) per position by hash chains (high preset).

    Positions are sorted stably by their 3-byte hash, so the rows above a
    row with the same key are its most recent same-hash predecessors.  For
    each depth of :func:`probe_schedule` every row compares its
    ``probe_words`` packed words with the row that far above it: some
    twenty elementwise ops per depth over the sorted ``[W, B, N]`` words
    and a shifted view of them (no per-candidate gathers), the probe length
    taken from the first differing word.

    Args/returns as :func:`find_matches`.
    """
    dev = buf.device
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    nt = n_total.int()[:, None]
    limit = (nt - idx).clamp(0, MAX_MATCH)
    hashable = (idx >= hstart.int()[:, None]) & (idx <= nt - 3)
    keys = torch.where(hashable, hash3(buf, N), INVALID_KEY)

    packed = _as_int32_bits(pack_words(buf))
    _, perm = torch.sort(keys, dim=1, stable=True)
    skey = keys.gather(1, perm)
    spos = perm.int()
    W = probe_words
    # Probe words of the sorted rows, [W + 1, B, N]; row W is a sentinel
    # (0 here, 1 in the shifted copy) that differs for every pair.
    sprobe = torch.stack([packed[:, 4 * w : N + 4 * w].gather(1, perm) for w in range(W)]
                         + [torch.zeros_like(spos)])

    ks = probe_schedule(num_checks)
    KMAX = ks[-1]
    valid_row = skey < INVALID_KEY
    # KMAX rows of padding above row 0: a key that matches nothing,
    # position 0 and zero probe words.
    skey_ext = torch.nn.functional.pad(skey, (KMAX, 0), value=INVALID_KEY + 1)
    spos_ext = torch.nn.functional.pad(spos, (KMAX, 0))
    sprobe_ext = torch.nn.functional.pad(sprobe, (KMAX, 0))  # [W + 1, B, KMAX + N]
    sprobe_ext[W] = 1
    # Word w of a differing pair scores W + 1 - w: the largest score marks
    # the first differing word (a max over words, cheaper than argmax).
    rank = torch.arange(W + 1, 0, -1, dtype=torch.uint8, device=dev)[:, None, None]

    best = torch.zeros_like(spos)
    for k in ks:
        s = KMAX - k
        dist = spos - spos_ext[:, s : s + N]
        ok = (skey == skey_ext[:, s : s + N]) & valid_row & (dist <= WINDOW_SIZE)
        # Probe length: 4 bytes per leading equal word, then the matched
        # low bytes of the first differing word (the sentinel adds none).
        other = sprobe_ext[:, :, s : s + N]
        lead = (W + 1) - ((sprobe != other).view(torch.uint8) * rank).amax(dim=0).long()
        first = sprobe.gather(0, lead[None])[0] ^ other.gather(0, lead[None])[0]
        lp = (4 * lead.int() + ((first & 0xFF) == 0).int() + ((first & 0xFFFF) == 0).int()
              + ((first & 0xFFFFFF) == 0).int())
        score = torch.where(ok & (lp >= 3), (lp << 16) | (WINDOW_SIZE + 1 - dist), 0)
        best = torch.maximum(best, score)
    return _unsort_and_extend(best, perm, limit, N)


def find_rle_matches(buf, n_total, hstart, N: int):
    """Distance-1 run matches only (the reference's RLE mode, rle.rs:23-63)."""
    dev = buf.device
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    nt = n_total.int()[:, None]
    eq = torch.nn.functional.pad(buf[:, 1:N] == buf[:, : N - 1], (1, 0))
    eq = eq & (idx - 1 >= hstart.int()[:, None]) & (idx < nt)
    next_break = _rev_cummin(torch.where(eq, N + MAX_MATCH, idx))
    length = torch.minimum(next_break - idx, (nt - idx).clamp(0, MAX_MATCH))
    best_len = torch.where(length >= 3, length, 0)
    return best_len, (best_len > 0).int()
