"""Device-side DEFLATE decoder: the inflate validator.

Port of ``deflate_rs_tpu/ops/inflate_device.py``.  It decodes any raw
DEFLATE stream with the device doing all decoding math; the host only
sequences blocks: one ``BlockDecoder.decode`` per DEFLATE block and one
fetch of that block's five-integer ``meta`` before the next.  This is a
VALIDATOR: correctness and device residency are its contract, not
throughput.

Huffman decoding is a bit-serial chain in a host decoder.  Here it is
decoded speculatively at every bit offset of the block's window:

1. per bit b, the MSB-first code value is accumulated level by level (15
   shifted rows) against the block's canonical (first_code, count, offset)
   tables, so every bit learns "if a litlen code started here: symbol,
   length";
2. length/distance extra bits and the distance code are gathers at
   b + codelen;
3. the true token sequence is the orbit of the window's first bit under
   ``step[b]``, the bits the token at b consumes: ``ops/parse.reachable``,
   the plain pointer doubling (steps reach the window's width, far beyond
   the ``parse_scan`` kernel's 258, so no kernel runs here);
4. back-references are resolved after all blocks, in one log-depth
   source-pointer doubling over the output buffer.

The dynamic header takes the same route where the JAX package runs a scalar
loop on its device (``lax.while_loop`` over up to 320 code-length symbols):
a code-length symbol and its repeat bits are decoded at every bit offset of
the header's window, the visited offsets are the orbit of the first, and the
runs are placed by a prefix sum of their repeat counts.  The result equals
the loop's for any input bits, invalid codes included.

The block type picks the branch (the JAX ``lax.cond``): the host reads the
block's three header bits from its own copy of the stream at the bit
position it already holds, so the choice costs no fetch; the device computes
them again for ``meta``.

Index semantics follow the JAX code exactly: every window read is clamped as
a size-1 ``dynamic_slice`` clamps, scatters with ``mode="drop"`` write into
one spare slot that is cut, and the resolver's gathers wrap negative indices
and fill out-of-range ones as ``jnp.take`` does.  No index reaches a tensor
unclamped, so a malformed stream raises ``ValueError`` and never trips a
device-side assert.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C
from .parse import reachable

_BIGPOS = 1 << 29
_INT32_MIN = -(1 << 31)
CLL = 320  # hlit + hdist <= 288 + 32
# Bits the code-length symbols of one header can span: 320 symbols of at
# most 7 code bits and 7 repeat bits.
HDR_WINDOW = CLL * (C.MAX_CLEN_CODE_LENGTH + 7)
MAX_BLOCKS = 4096


def _at(bits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``bits[idx]`` with each index clamped into range (JAX's size-1
    ``dynamic_slice``)."""
    return bits[idx.clamp(0, bits.shape[0] - 1)]


def _read(bits: torch.Tensor, pos, k: int) -> torch.Tensor:
    """``k`` bits LSB-first at ``pos`` (an int, a 0-d or a 1-d tensor)."""
    j = torch.arange(k, device=bits.device)
    idx = pos[..., None] + j if torch.is_tensor(pos) else j + pos  # no host-to-device copy
    return (_at(bits, idx).long() << j).sum(-1)


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``, 0 for an index outside the table (the JAX package's
    one-hot ``table_lookup``)."""
    n = table.shape[0]
    return torch.where((idx >= 0) & (idx < n), table[idx.clamp(0, n - 1)], 0)


def _take(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``jnp.take(x, idx)``: negative indices in [-n, 0) wrap, indices
    outside [-n, n) give ``fill``."""
    n = x.shape[0]
    j = torch.where(idx < 0, idx + n, idx)
    return torch.where((j >= 0) & (j < n), x[j.clamp(0, n - 1)], fill)


def _scatter_drop(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].set(vals, mode="drop")`` for ``idx >= 0``: indices
    past the end land on a spare slot that is cut."""
    n = base.shape[0]
    out = torch.cat([base, base.new_zeros(1)])
    return out.scatter_(0, idx.clamp(max=n), vals.to(base.dtype))[:n]


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """The constant tables on ``device``, copied there once: a copy from the
    host in the middle of a block would wait for the device."""
    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    return {"clen_order": dev(C.CLEN_ORDER), "fixed_l": dev(C.FIXED_LITLEN_LENGTHS),
            "fixed_d": dev(C.FIXED_DIST_LENGTHS)}


# ---------------------------------------------------------------------------
# Canonical decode tables from code lengths
# ---------------------------------------------------------------------------


def _decode_tables(lengths: torch.Tensor, max_len: int):
    """(first_code, count, offset, sym_sorted) for one alphabet.

    ``sym_sorted`` lists the symbols in canonical order (code length, then
    symbol), so a decoded (length, rank) pair maps to a symbol with one
    lookup.  The sort keys are unique, so any sort gives the JAX order.
    """
    dev = lengths.device
    lens = torch.arange(max_len + 1, device=dev)
    count = (lengths[:, None] == lens).sum(0)
    count[0] = 0
    # first_code[l] = (first_code[l-1] + count[l-1]) << 1, unrolled:
    # the sum over j < l of count[j] << (l - j).
    shift = lens[:, None] - lens[None, :]
    first_code = torch.where(shift > 0, count[None, :] << shift.clamp(min=0), 0).sum(1)
    offset = torch.cumsum(count, 0) - count
    sym = torch.arange(lengths.shape[0], device=dev)
    key = torch.where(lengths > 0, lengths * 512 + sym, _BIGPOS + sym)
    return first_code, count, offset, torch.argsort(key)


def _decode_at_all_bits(bitw: torch.Tensor, W: int, tables, max_len: int):
    """Per-bit speculative decode: (sym, codelen) if a code started at b.

    ``bitw``: 0/1 bits, at least ``W + max_len - 1`` of them.  Offsets where
    no code fits get sym = -1 and codelen = max_len; such offsets are never
    on the token orbit of a valid stream, or invalidate the block through
    its ``ok``.
    """
    first_code, count, offset, sym_sorted = tables
    dev = bitw.device
    c = torch.zeros(W, dtype=torch.int64, device=dev)
    found = torch.zeros(W, dtype=torch.bool, device=dev)
    codelen = torch.full((W,), max_len, dtype=torch.int64, device=dev)
    sym_pos = torch.zeros(W, dtype=torch.int64, device=dev)
    for l in range(1, max_len + 1):
        c = (c << 1) | bitw[l - 1 : l - 1 + W]
        ok = ~found & (c >= first_code[l]) & (c < first_code[l] + count[l])
        sym_pos = torch.where(ok, offset[l] + c - first_code[l], sym_pos)
        codelen = torch.where(ok, l, codelen)
        found |= ok
    return torch.where(found, _lookup(sym_sorted, sym_pos), -1), codelen


def _len_attrs(lc: torch.Tensor):
    """(extra_bits, base) of length code index 0..28, by arithmetic
    (RFC 1951 section 3.2.5; equal to ``constants.LENGTH_*``)."""
    e = ((lc - 4) >> 2).clamp(min=0)
    base = torch.where(lc < 4, lc + 3, (((lc & 3) + 4) << e) + 3)
    e = torch.where(lc == 28, 0, e)
    base = torch.where(lc == 28, C.MAX_MATCH, base)
    return e, base


def _dist_attrs(dc: torch.Tensor):
    """(extra_bits, base) of distance code 0..29."""
    e = ((dc >> 1) - 1).clamp(min=0)
    base = torch.where(dc < 2, dc + 1, (((dc & 1) + 2) << e) + 1)
    return e, base


# ---------------------------------------------------------------------------
# Dynamic header (RFC 1951 section 3.2.7)
# ---------------------------------------------------------------------------


def _parse_dynamic_header(bits: torch.Tensor, pos: int):
    """HLIT/HDIST/HCLEN, the code-length code and the run-length coded
    lengths at bit ``pos`` of ``bits`` (0/1 values).

    Returns (litlen lengths [288], distance lengths [30], bit position after
    the header), exactly what the JAX package's scalar loop returns for the
    same bits.  That loop decodes one code-length symbol per step at bit p:
    p advances by the code's length (0 for an invalid code, whose symbol is
    then the first in canonical order) plus the symbol's repeat bits, and
    ``i`` by the run length, until ``i`` reaches hlit + hdist.  Here every
    bit offset of the window decodes its symbol at once, the steps' orbit
    gives the offsets the loop visits, a prefix sum of their run lengths
    gives each run's place, and a node whose step is 0 repeats in place, as
    the loop does, until the lengths are complete.
    """
    dev = bits.device
    hlit = _read(bits, pos, 5) + 257
    hdist = _read(bits, pos + 5, 5) + 1
    hclen = _read(bits, pos + 10, 4) + 4
    total = hlit + hdist

    i19 = torch.arange(C.NUM_CLEN_SYMBOLS, device=dev)
    v = _read(bits, pos + 14 + 3 * i19, 3)
    order = _tables(dev)["clen_order"]
    cl_lens = torch.zeros(C.NUM_CLEN_SYMBOLS, dtype=torch.int64, device=dev).scatter_(
        0, order, torch.where(i19 < hclen, v, 0))
    fc, cnt, off, ssym = _decode_tables(cl_lens, C.MAX_CLEN_CODE_LENGTH)
    p0 = pos + 14 + 3 * hclen

    # A code-length symbol at every offset q of the window.
    H = HDR_WINDOW
    q = torch.arange(H, device=dev)
    hb = _at(bits, p0 + torch.arange(H + 16, device=dev)).long()
    c = torch.zeros(H, dtype=torch.int64, device=dev)
    l_found = torch.zeros(H, dtype=torch.int64, device=dev)
    rank = torch.zeros(H, dtype=torch.int64, device=dev)
    for l in range(1, C.MAX_CLEN_CODE_LENGTH + 1):
        c = (c << 1) | hb[l - 1 : l - 1 + H]
        hit = (l_found == 0) & (c >= fc[l]) & (c < fc[l] + cnt[l])
        rank = torch.where(hit, off[l] + c - fc[l], rank)
        l_found = torch.where(hit, l, l_found)
    s = _lookup(ssym, rank)
    rep_bits = torch.where(s == 16, 2, torch.where(s == 17, 3, torch.where(s == 18, 7, 0)))
    rep_base = torch.where(s == 16, 3, torch.where(s == 17, 3, torch.where(s == 18, 11, 1)))
    win7 = sum(hb[j : j + H + 8] << j for j in range(7))  # 7 bits LSB-first at each offset
    ext = win7[q + l_found] & ((1 << rep_bits) - 1)
    step = l_found + rep_bits
    n_rep = rep_base + ext

    # The offsets the loop visits: the orbit of 0 (a step of 0 is a fixed
    # point).  320 steps of at least 1 run reach any total within H bits.
    nxt = torch.cat([(q + step).clamp(max=H), torch.full((1,), H, device=dev)])
    vis = reachable(nxt[None], 0)[0, :H]
    nv = torch.where(vis, n_rep, 0)
    before = torch.cumsum(nv, 0) - nv  # i when the loop reaches offset q
    term = vis & ((before + n_rep >= total) | (step == 0))
    last = torch.where(term, q, H).min().clamp(max=H - 1)
    b_l, n_l, s_l = before[last], n_rep[last], step[last]
    reps = torch.where(s_l == 0, (total - b_l + n_l - 1) // n_l, 1)
    i_end = b_l + reps * n_l

    # Run values: a length 0..15, zeros for 17 and 18, and for 16 the value
    # of the last visited symbol that was not a 16 (0 before any).
    own = torch.where(s <= 15, s, 0)
    anchor = torch.cummax(torch.where(vis & (s != 16), q, -1), 0).values
    val = torch.where(s == 16, torch.where(anchor >= 0, own[anchor.clamp(min=0)], 0), own)

    # Place the runs: mark each executed offset at its start, forward-fill.
    executed = vis & (q <= last)
    starts = torch.where(executed & (before < CLL), before, CLL)
    mark = _scatter_drop(torch.full((CLL,), -1, dtype=torch.int64, device=dev), starts,
                         torch.where(executed, q, -1))
    node = torch.cummax(mark, 0).values
    idx = torch.arange(CLL, device=dev)
    lens = torch.where((idx < i_end) & (node >= 0), val[node.clamp(min=0)], 0)

    a = torch.arange(C.NUM_LITLEN_SYMBOLS, device=dev)
    l_full = torch.where(a < hlit, lens[: C.NUM_LITLEN_SYMBOLS], 0)
    d = torch.arange(C.NUM_DIST_SYMBOLS, device=dev)
    d_full = torch.where(d < hdist, lens[(d + hlit).clamp(0, CLL - 1)], 0)
    return l_full, d_full, p0 + last + s_l


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------


class BlockDecoder:
    """The per-block decoder of one stream.

    Shapes as in the JAX package: the stream padded to ``NB`` bytes (a
    multiple of 1,024 with 8 spare), an output of ``OUT = out_cap`` bytes and
    a bit window of ``W`` (``block_window`` or a cover of any block whose
    output fits ``out_cap``, rounded up to 16).  The stream's bits are
    unpacked once, on the device, with ``W + 64`` zero bits behind them.
    """

    def __init__(self, stream: bytes, out_cap: int, block_window: int = 0, device="cuda"):
        self.device = dev = torch.device(device)
        self.NB = NB = max(1024, -(-(len(stream) + 8) // 1024) * 1024)
        self.OUT = OUT = out_cap
        W = block_window or min(9 * OUT + 4096, NB * 8 + 64)
        self.W = W = (W + 15) & ~15
        host = np.frombuffer(bytes(stream).ljust(NB, b"\0"), np.uint8)
        self.host_bits = np.unpackbits(host, bitorder="little")
        self.data = torch.from_numpy(host.copy()).to(dev)
        shifts = torch.arange(8, dtype=torch.uint8, device=dev)
        bits = ((self.data[:, None] >> shifts) & 1).reshape(-1)
        self.bits = torch.cat([bits, torch.zeros(W + 64, dtype=torch.uint8, device=dev)])
        self.k_out = torch.arange(OUT, device=dev)
        self.b = torch.arange(W, device=dev)
        self.span = torch.arange(W + 64, device=dev)

    def decode(self, bitpos: int, out_pos: int, lit, src, known):
        """Decode the block at bit ``bitpos`` whose output starts at
        ``out_pos``.  ``lit``, ``src`` (int64[OUT]) and ``known``
        (bool[OUT]) carry the output state; returns their successors and
        ``meta`` int64[5]: next bit position, next output position, BFINAL,
        ok, BTYPE."""
        bits = self.bits
        hb = self.host_bits
        bfinal = bits[bitpos].long()
        btype_d = bits[bitpos + 1].long() | (bits[bitpos + 2].long() << 1)
        btype = int(hb[bitpos + 1]) | int(hb[bitpos + 2]) << 1
        if btype == C.BTYPE_STORED:
            lit, src, known, nbitpos, nout, ok = self._stored(bitpos + 3, out_pos, lit, src, known)
        else:
            lit, src, known, nbitpos, nout, ok = self._huffman(btype, bitpos + 3, out_pos, lit,
                                                               src, known)
        meta = torch.stack([nbitpos, nout, bfinal, ok, btype_d]).long()
        return lit, src, known, meta

    def _stored(self, hpos: int, out_pos: int, lit, src, known):
        p = (hpos + 7) & ~7  # pad to a byte
        byte0 = p >> 3
        ln = _read(self.bits, p, 16)
        k = self.k_out
        v = self.data[(byte0 + 4 + k - out_pos).clamp(0, self.NB - 1)].long()
        inblk = (k >= out_pos) & (k < out_pos + ln)
        return (torch.where(inblk, v, lit), torch.where(inblk, k, src), known | inblk,
                (byte0 + 4) * 8 + ln * 8, out_pos + ln, torch.ones_like(ln))

    def _huffman(self, btype: int, hpos: int, out_pos: int, lit, src, known):
        W, OUT, b = self.W, self.OUT, self.b
        if btype == C.BTYPE_DYNAMIC:
            l_len, d_len, tstart = _parse_dynamic_header(self.bits, hpos)
        else:
            tab = _tables(self.device)
            l_len, d_len = tab["fixed_l"], tab["fixed_d"]
            tstart = torch.full((), hpos, dtype=torch.int64, device=self.device)
        l_tab = _decode_tables(l_len, C.MAX_CODE_LENGTH)
        d_tab = _decode_tables(d_len, C.MAX_CODE_LENGTH)

        start = tstart.clamp(0, self.bits.shape[0] - (W + 64))  # dynamic_slice's clamp
        bitw = self.bits[start + self.span].long()
        lsym, l1 = _decode_at_all_bits(bitw, W, l_tab, C.MAX_CODE_LENGTH)
        dsym_b, l2_b = _decode_at_all_bits(bitw, W, d_tab, C.MAX_CODE_LENGTH)
        win = sum(bitw[j : j + W] << j for j in range(16))  # 16 bits LSB-first at each offset

        is_lit = (lsym >= 0) & (lsym <= 255)
        is_eob = lsym == C.END_OF_BLOCK
        is_len = lsym >= 257
        e1, base1 = _len_attrs((lsym - 257).clamp(0, 28))
        len_val = base1 + (win[(b + l1).clamp(0, W - 1)] & ((1 << e1) - 1))
        b2 = (b + l1 + e1).clamp(0, W - 1)
        dsym, l2 = dsym_b[b2], l2_b[b2]
        e2, base2 = _dist_attrs(dsym.clamp(0, 29))
        dist_val = base2 + (win[(b2 + l2).clamp(0, W - 1)] & ((1 << e2) - 1))

        bad = (lsym < 0) | (is_len & (dsym < 0))
        step = torch.where(is_lit, l1, torch.where(is_len, l1 + e1 + l2 + e2, W))
        step = torch.where(bad | is_eob, W, step).clamp(min=1)

        # The token orbit from offset 0 of the window.
        nxt = torch.cat([(b + step).clamp(max=W), torch.full((1,), W, device=self.device)])
        tok = reachable(nxt[None], 0)[0, :W]

        # Output offsets per token.
        cnt = torch.where(tok & is_lit, 1, torch.where(tok & is_len, len_val, 0))
        ooff = out_pos + torch.cumsum(cnt, 0) - cnt
        lit_idx = torch.where(tok & is_lit, ooff, OUT)
        lit2 = _scatter_drop(lit, lit_idx, torch.where(is_lit, lsym, 0))
        known2 = _scatter_drop(known, lit_idx, torch.ones_like(is_lit))
        # Matches: scatter (start, dist), then forward-fill over the span;
        # literal bytes break the fill.
        m_idx = torch.where(tok & is_len, ooff, OUT)
        neg = torch.full((OUT,), -1, dtype=torch.int64, device=self.device)
        mstart = _scatter_drop(neg, m_idx, torch.where(is_len, ooff, -1))
        mdist = _scatter_drop(torch.zeros_like(neg), m_idx, torch.where(is_len, dist_val, 0))
        breaker = _scatter_drop(neg, lit_idx, torch.where(is_lit, ooff, -1))
        last_start = torch.cummax(torch.maximum(mstart, breaker), 0).values
        ls = last_start.clamp(0, OUT - 1)
        d_at, is_match_start = mdist[ls], mstart[ls] >= 0

        eob_pos = torch.where(tok & is_eob, b, W).min()
        eob_len = l1[eob_pos.clamp(0, W - 1)]
        n_add = cnt.sum()
        k = self.k_out
        in_new = (k >= out_pos) & (k < out_pos + n_add)
        fill = in_new & ~known2 & is_match_start & (last_start >= 0)
        src2 = torch.where(fill, k - d_at, src)
        ok = (eob_pos < W) & ~(tok & (step >= W) & ~is_eob).any()
        return lit2, src2, known2, tstart + eob_pos + eob_len, out_pos + n_add, ok


def resolve(lit, src, known, n: int):
    """Chase every match byte's source pointer to a literal (log-depth
    doubling).  Returns (uint8[OUT] output, whether the first ``n`` bytes
    all resolved)."""
    OUT = lit.shape[0]
    val = torch.where(known, lit, 0)
    for _ in range(max(1, (OUT - 1).bit_length())):
        v2 = _take(val, src, _INT32_MIN)
        k2 = _take(known, src, True)
        val = torch.where(known, val, v2)
        known = known | k2
        src = _take(src, src, _INT32_MIN)
    done = torch.where(torch.arange(OUT, device=lit.device) < n, known, True).all()
    return (val & 0xFF).to(torch.uint8), done


def inflate_device(stream: bytes, out_cap: int, *, block_window: int = 0,
                   device="cuda") -> bytes:
    """Decode a raw DEFLATE stream with all decode math on ``device``.

    Args:
      stream: the compressed bytes (raw deflate, no zlib/gzip framing).
      out_cap: output capacity (>= the decoded size).
      block_window: per-block bit window; the default covers any block
        whose output fits ``out_cap``.

    Returns the decoded bytes.  Raises ValueError on a malformed stream or a
    block beyond the window (the validator's contract, not a lenient
    decoder).
    """
    dec = BlockDecoder(stream, out_cap, block_window, device)
    OUT = dec.OUT
    lit = torch.zeros(OUT, dtype=torch.int64, device=dec.device)
    src = torch.arange(OUT, device=dec.device)
    known = torch.zeros(OUT, dtype=torch.bool, device=dec.device)
    bitpos = out_pos = 0
    for _ in range(MAX_BLOCKS):
        lit, src, known, meta = dec.decode(bitpos, out_pos, lit, src, known)
        nbitpos, nout, bfinal, ok, btype = meta.tolist()  # the block's one fetch
        # Against the TRUE stream length, not the padded buffer: the zero
        # padding decodes (fixed code 0000000 is EOB), which would accept a
        # truncated stream.
        if not ok or nout > OUT or nbitpos > len(stream) * 8:
            raise ValueError(f"inflate_device: bad block (btype={btype}, ok={ok}, "
                             f"out={nout}/{OUT}, bitpos={nbitpos})")
        bitpos, out_pos = nbitpos, nout
        if bfinal:
            break
    else:
        raise ValueError(f"inflate_device: no final block in {MAX_BLOCKS} blocks")
    out, resolved = resolve(lit, src, known, out_pos)
    if not bool(resolved):
        raise ValueError("inflate_device: unresolved back-references")
    return out[:out_pos].cpu().numpy().tobytes()
