"""The per-chunk DEFLATE encoder, batched over chunks: ``ChunkEncoder``.

Port of ``deflate_rs_tpu/ops/chunk_encode.py`` (``encode_chunk``; the
reference's main loop ``compress_data_dynamic_n``, compress.rs:80) for every
preset.  Each row of a batch is one chunk: up to ``emit_size`` payload bytes
preceded by up to 32 KiB of history.  Stages, all on the device of the
input tensors:

  matcher (suffix sort, hash chains, distance-1 runs or none) -> long-range
  pass (lr_measure kernel) -> chain and stride extension -> lazy jump steps
  -> parse (parse_scan kernel) -> per-quarter histograms (quarter_hist
  kernel) -> block split scored by the entropy proxy or exactly ->
  package-merge code lengths (package_merge kernel) -> header RLE -> exact
  stored / fixed / dynamic choice (and the force modes) -> token fields
  (token_fields kernel) -> bit pack.

The host-constant tables (split machinery, fixed codes, extra-bit tables,
the proxy's switch table) are registered buffers, so ``.to(device)``
moves them with the module.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import constants as C
from ..compression_options import CompressionOptions, SpecialOptions
from .bitpack import pack_fields
from .canonical import canonical_codes
from .checksum import CRC_TABLE, adler32_parts_device, crc32_raw_device, shift_byte_tables
from .code_lengths import CL_CAP, encode_code_lengths
from .field_kernel import token_fields
from .hist_kernel import quarter_histograms
from .longrange import global_dominant_lengths, local_dominant_lengths
from .matching import (chain_extend, find_matches, find_matches_hash, find_rle_matches,
                       stride_extend)
from .package_merge import package_merge_rows
from .parse import build_jumps
from .parse_scan import parse_scan
from .proxy import F32_EXACT_BITS, SWITCH_MARGIN, load_switch_table, proxy_bits, row_offsets
from .symbolmap import dist_code, length_code

HALO = C.WINDOW_SIZE  # history bytes preceding the emit region
PAD = 72  # tail padding so packed-word probe reads stay in bounds


def out_words(emit_size: int, force_fixed: bool = False) -> int:
    """Output words per chunk.  Normal and ForceStored never exceed the
    stored bound plus slack (the cost model takes the cheaper one);
    ForceFixed may emit 9 bits a byte (fixed codes of literals 144..255),
    so it gets the 9/8 bound."""
    if force_fixed:
        return (9 * emit_size) // 32 + 2048
    return emit_size // 4 + (emit_size // C.MAX_STORED_BLOCK + 2) * 2 + 64


def _make_compositions(nq: int):
    comps = []
    for mask in range(1 << (nq - 1)):
        bounds = [0] + [b + 1 for b in range(nq - 1) if (mask >> b) & 1] + [nq]
        comps.append(tuple((bounds[t], bounds[t + 1]) for t in range(len(bounds) - 1)))
    comps.sort(key=len)  # argmin picks the FIRST min => fewer blocks on ties
    return comps


class SplitCfg:
    """Static split machinery for an ``nq``-quarter chunk (numpy), as in the
    JAX package's ``_SplitCfg``: contiguous quarter ranges, compositions of
    ranges into blocks, and per (quarter, composition) selectors."""

    def __init__(self, nq: int):
        self.nq = nq
        self.ranges = [(i, j) for i in range(nq) for j in range(i + 1, nq + 1)]
        self.range_id = {r: k for k, r in enumerate(self.ranges)}
        comps = self.comps = _make_compositions(nq)
        self.hdr_start = np.array(
            [[int(any(r[0] == q for r in c)) for c in comps] for q in range(nq)], np.int32)
        self.blk_end = np.array(
            [[int(any(r[1] == q + 1 for r in c)) for c in comps] for q in range(nq)], np.int32)
        self.last_start = np.array([max(r[0] for r in c) for c in comps], np.int32)
        self.slotq = np.array(
            [[next(t for t, r in enumerate(c) if r[0] <= q < r[1]) for c in comps]
             for q in range(nq)], np.int32)
        self.mem = np.array(
            [[[1 if (t < len(c) and c[t][0] <= q < c[t][1]) else 0 for c in comps]
              for q in range(nq)] for t in range(nq)], np.int32)
        self.exist = np.array(
            [[1 if t < len(c) else 0 for c in comps] for t in range(nq)], np.int32)
        # Range id of each composition's t-th block (0 where it has none).
        self.rid_t = np.array(
            [[self.range_id[c[t]] if t < len(c) else 0 for c in comps] for t in range(nq)],
            np.int32)
        self.comp_ranges = np.array(
            [[1 if r in c else 0 for r in self.ranges] for c in comps], np.int32)


def _gather_slots(x: torch.Tensor, sid: torch.Tensor) -> torch.Tensor:
    """x[b, sid[b, q], ...] for x [B, X, ...] and sid [B, nq]."""
    idx = sid.reshape(sid.shape + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand(sid.shape + x.shape[2:]))


class ChunkEncoder(nn.Module):
    """Encode a batch of chunks at one (options, emit_size) configuration.

    ``with_checksums`` adds the Adler-32 and raw CRC-32 partials of each
    payload to the outputs (``s1``, ``s2``, ``crc_raw``), for callers that
    never read the payload on the host.  ``stored_payload_fields=False``
    leaves the stored sub-blocks out of the bit pack: the compacted consumers
    (the corpus engine, the streaming encoders' batched path) never read a
    stored chunk's words, since the host re-emits it from the raw payload;
    ``total_bits`` and ``data_bits`` stay exact either way."""

    def __init__(self, options: CompressionOptions, emit_size: int, *,
                 with_checksums: bool = False, stored_payload_fields: bool = True):
        super().__init__()
        self.options = options
        self.with_checksums = with_checksums
        self.stored_payload_fields = stored_payload_fields
        self.E = emit_size
        self.N = HALO + emit_size
        sc = self.sc = SplitCfg(options.num_quarters)
        if emit_size % sc.nq:
            raise ValueError(f"emit_size {emit_size} must divide by num_quarters {sc.nq}")
        self.num_words = out_words(emit_size, options.special == SpecialOptions.ForceFixed)
        # A range of more than 1,118,480 positions may pass float32's exact
        # integers with its proxy bits (15 a symbol, EOB included).
        self.proxy_float32 = C.MAX_CODE_LENGTH * (emit_size + 1) >= F32_EXACT_BITS

        def buf(name, arr, dtype=np.int64):
            self.register_buffer(name, torch.as_tensor(np.asarray(arr, dtype)), persistent=False)

        # The switch offsets a range can reach: its total is at most its
        # emit_size tokens and EOB.
        tot_max = emit_size + 1 + SWITCH_MARGIN
        buf("proxy_table", load_switch_table(tot_max), np.int8)
        buf("proxy_offsets", row_offsets(tot_max))
        buf("rid_t_c", sc.rid_t.T)                         # [C, t]
        buf("comp_ranges", sc.comp_ranges)                 # [C, R]
        buf("range_lo", [r[0] for r in sc.ranges])         # [R]
        buf("range_hi", [r[1] for r in sc.ranges])         # [R]
        buf("mem_c", sc.mem.transpose(2, 0, 1))            # [C, t, q]
        buf("exist_c", sc.exist.T)                         # [C, t]
        buf("hdr_start_c", sc.hdr_start.T)                 # [C, q]
        buf("blk_end_c", sc.blk_end.T)                     # [C, q]
        buf("slotq_c", sc.slotq.T)                         # [C, q]
        buf("last_start", sc.last_start)                   # [C]
        buf("l_extra", np.concatenate([np.zeros(257, np.int64), C.LENGTH_EXTRA_BITS]))
        buf("d_extra", C.DIST_EXTRA_BITS)
        buf("fixed_l_len", C.FIXED_LITLEN_LENGTHS)         # [288]
        buf("fixed_d_len", C.FIXED_DIST_LENGTHS)           # [30]
        buf("clen_order", C.CLEN_ORDER)
        buf("dh_bits", [5, 5, 4])
        buf("sh_bits", [3, 5, 16, 16])
        buf("sy_vals", [0, 0, 0x0000, 0xFFFF])
        if with_checksums:
            buf("crc_table", CRC_TABLE)
            buf("crc_shift_tables", shift_byte_tables(emit_size))

    @staticmethod
    def _code_lengths(l_freq, d_freq):
        """Package-merge code lengths of litlen [B, X, 286] and distance
        [B, X, 30] histograms in one batched call (the distance rows ride
        padded to the litlen width; unused symbols are inert)."""
        B, X, NL = l_freq.shape
        ND = d_freq.shape[-1]
        ld = package_merge_rows(
            torch.cat([l_freq, torch.nn.functional.pad(d_freq, (0, NL - ND))],
                      dim=1).reshape(B * 2 * X, NL),
            C.MAX_CODE_LENGTH).long().view(B, 2 * X, NL)
        return ld[:, :X], ld[:, X:, :ND]

    def _token_bits(self, l_freq, d_freq, l_len, d_len):
        """Token bits, extra bits included, of histograms under lengths."""
        return ((l_freq * (l_len + self.l_extra)).sum(-1)
                + (d_freq * (d_len + self.d_extra)).sum(-1))

    def _headers(self, l_len, d_len) -> dict:
        """Dynamic-header pieces of code-length rows [B, X, 286] / [B, X, 30]:
        HLIT/HDIST/HCLEN, the RLE of the concatenated lengths (``sym``,
        ``n``, ``extra_bits``, ``extra_vals``), the clen code lengths and
        the header's exact size in bits."""
        B, X, NL = l_len.shape
        ND = d_len.shape[-1]
        dev = l_len.device
        hlit = (torch.where(l_len > 0, torch.arange(NL, device=dev), -1).amax(-1) + 1).clamp(
            C.MIN_NUM_LITLEN_CODES, NL)
        hdist = (torch.where(d_len > 0, torch.arange(ND, device=dev), -1).amax(-1) + 1).clamp(
            C.MIN_NUM_DIST_CODES, ND)
        j = torch.arange(CL_CAP, device=dev)
        cl = torch.where(
            j < hlit[..., None],
            l_len[..., j.clamp(0, NL - 1)],
            d_len.gather(-1, (j - hlit[..., None]).clamp(0, ND - 1)))
        rle = encode_code_lengths(cl.reshape(B * X, CL_CAP), (hlit + hdist).reshape(-1))
        rle = {k: v.view((B, X) + v.shape[1:]) for k, v in rle.items()}
        clen_len = package_merge_rows(
            rle["freq"].reshape(B * X, 19), C.MAX_CLEN_CODE_LENGTH).long().view(B, X, 19)
        hclen = (torch.where(clen_len[..., self.clen_order] > 0, torch.arange(19, device=dev), -1)
                 .amax(-1) + 1).clamp(4, 19)
        used = j < rle["n"][..., None]
        bits = (14 + 3 * hclen + torch.where(used, clen_len.gather(-1, rle["sym"]), 0).sum(-1)
                + rle["extra_bits"].sum(-1))
        return {"hlit": hlit, "hdist": hdist, "hclen": hclen, "clen_len": clen_len,
                "bits": bits, "sym": rle["sym"], "n": rle["n"],
                "extra_bits": rle["extra_bits"], "extra_vals": rle["extra_vals"]}

    # The stages of ``forward``, in order.  Each is a method of that name that
    # takes the state the stages before it left (a dict of tensors, the
    # dynamic-header pieces as a dict of their own) and returns it with its
    # own outputs added, so a caller can run one stage alone on the real
    # outputs of the stages before it (``tools/stage_timing.py`` does).
    STAGES = ("lz77", "long_range", "parse", "symbols", "histograms", "scoring", "tables",
              "fields", "pack", "checksums")

    def forward(self, bufs: torch.Tensor, hist_len: torch.Tensor, n: torch.Tensor,
                is_last: torch.Tensor) -> dict:
        """Encode ``bufs`` uint8[B, HALO + E + PAD] (history ending at HALO,
        payload at HALO .. HALO + n).  ``hist_len``, ``n``: int[B];
        ``is_last``: bool[B].  Returns the JAX ``encode_chunk`` dict with a
        leading batch axis: ``words`` (int64 holding uint32), ``total_bits``,
        ``data_bits``, ``btype``, ``ntokens``, and with ``with_checksums``
        ``s1``, ``s2``, ``crc_raw``."""
        state = self.inputs(bufs, hist_len, n, is_last)
        for name in self.STAGES:
            state = getattr(self, name)(state)
        return self.outputs(state)

    @staticmethod
    def inputs(bufs, hist_len, n, is_last) -> dict:
        """The state before the first stage: ``forward``'s arguments."""
        return {"bufs": bufs, "hist_len": hist_len, "n": n, "is_last": is_last}

    def outputs(self, state: dict) -> dict:
        """``forward``'s result out of the state after the last stage."""
        keys = ("words", "total_bits", "data_bits", "btype", "ntokens")
        if self.with_checksums:
            keys += ("s1", "s2", "crc_raw")
        return {k: state[k] for k in keys}

    def lz77(self, s: dict) -> dict:
        """The inputs on the device, then the matcher's best match per
        position (suffix sort, hash chains, distance-1 runs or none)."""
        opt, N = self.options, self.N
        bufs = s["bufs"]
        B, dev = bufs.shape[0], bufs.device
        n = s["n"].to(dev).long()
        is_last = s["is_last"].to(dev).bool()
        n_total = HALO + n
        hstart = HALO - s["hist_len"].to(dev).long()
        mode = opt.matcher_mode
        if mode == "rle":
            best_len, best_dist = find_rle_matches(bufs, n_total, hstart, N)
        elif mode == "none":  # huffman_only, turbo
            best_len = best_dist = torch.zeros((B, N), dtype=torch.int32, device=dev)
        elif opt.matcher_algo == "sa":
            best_len, best_dist = find_matches(
                bufs, N, n_total, hstart, opt.num_candidates, opt.probe_words,
                opt.resolved_sort_nkey, opt.resolved_sa_tail)
        else:
            best_len, best_dist = find_matches_hash(
                bufs, N, n_total, hstart, opt.num_candidates, opt.probe_words)
        return {**s, "n": n, "is_last": is_last, "n_total": n_total, "hstart": hstart,
                "best_len": best_len, "best_dist": best_dist}

    def long_range(self, s: dict) -> dict:
        """The hash matcher's long-range rounds (lr_measure kernel), then
        chain and stride extension; nothing for the other matchers."""
        opt, N = self.options, self.N
        if not (opt.matcher_mode == "hash" and opt.use_long_range):
            return s
        bufs, n_total, hstart = s["bufs"], s["n_total"], s["hstart"]
        best_len, best_dist = s["best_len"], s["best_dist"]
        cap = 4 * opt.probe_words
        d_cand = torch.where(best_len >= cap, best_dist, 0)
        idx = torch.arange(N, device=bufs.device)
        lim_n = (n_total[:, None] - idx).clamp(0, C.MAX_MATCH).int()
        lr = dict(num_dom=opt.resolved_num_dom, num_seg=opt.resolved_dom_segs,
                  sel=opt.resolved_lr_sel, harvest_stride=opt.resolved_lr_stride,
                  pair=opt.resolved_lr_pair)
        for _ in range(opt.resolved_dom_iters):
            if opt.lr_global:
                g_len, g_dist = global_dominant_lengths(
                    bufs, N, n_total, hstart, d_cand, num_global=opt.lr_global, **lr)
            else:
                g_len, g_dist = local_dominant_lengths(bufs, N, n_total, hstart, d_cand, **lr)
            take = g_len > best_len
            best_len = torch.where(take, g_len, best_len)
            best_dist = torch.where(take, g_dist, best_dist)
            d_cand = torch.where(best_len >= cap, best_dist, 0)
        best_len = stride_extend(
            chain_extend(best_len, best_dist, lim_n, N), best_dist, lim_n)
        ok3 = best_len >= C.MIN_MATCH
        return {**s, "best_len": torch.where(ok3, best_len, 0),
                "best_dist": torch.where(ok3, best_dist, 0)}

    def parse(self, s: dict) -> dict:
        """Lazy jump steps, then the token starts (parse_scan kernel)."""
        opt = self.options
        steps = build_jumps(
            s["best_len"][:, HALO:], s["best_dist"][:, HALO:], lazy=opt.lazy,
            lazy_if_less_than=min(opt.lazy_if_less_than, 258) if opt.lazy else 0)
        tvalid = parse_scan(steps.contiguous(), s["n"].int())
        return {**s, "steps": steps, "tvalid": tvalid, "ntokens": tvalid.sum(dim=1)}

    def symbols(self, s: dict) -> dict:
        """Each position's litlen and distance symbols and extra bits."""
        E = self.E
        length = s["steps"].long()
        is_match = length >= C.MIN_MATCH
        dist = torch.where(is_match, s["best_dist"][:, HALO:].long(), 0)
        lit = s["bufs"][:, HALO : HALO + E].long()
        lcode, len_extra_n, len_extra_v = length_code(length.clamp(C.MIN_MATCH, C.MAX_MATCH))
        dcode, dist_extra_n, dist_extra_v = dist_code(dist.clamp(1, C.WINDOW_SIZE))
        return {**s, "is_match": is_match,
                "lsym": torch.where(is_match, 257 + lcode, lit),
                "len_extra_n": torch.where(is_match, len_extra_n, 0),
                "len_extra_v": torch.where(is_match, len_extra_v, 0),
                "dcode": torch.where(is_match, dcode, 0),
                "dist_extra_n": torch.where(is_match, dist_extra_n, 0),
                "dist_extra_v": torch.where(is_match, dist_extra_v, 0)}

    def histograms(self, s: dict) -> dict:
        """Per-quarter histograms (quarter_hist kernel) and their sums over
        every contiguous range of quarters."""
        # Non-token positions count nowhere (999 / 99), as in token_fields.
        tvalid = s["tvalid"]
        lsym_eff = torch.where(tvalid, s["lsym"], 999).int()
        dcode_eff = torch.where(tvalid & s["is_match"], s["dcode"], 99).int()
        lf_q, df_q = quarter_histograms(lsym_eff, dcode_eff, self.sc.nq)
        lf_q, df_q = lf_q.long(), df_q.long()
        lf_cum = torch.nn.functional.pad(torch.cumsum(lf_q, dim=1), (0, 0, 1, 0))
        df_cum = torch.nn.functional.pad(torch.cumsum(df_q, dim=1), (0, 0, 1, 0))
        l_freq_r = lf_cum[:, self.range_hi] - lf_cum[:, self.range_lo]  # [B, R, 286]
        d_freq_r = df_cum[:, self.range_hi] - df_cum[:, self.range_lo]  # [B, R, 30]
        l_freq_r[:, :, C.END_OF_BLOCK] += 1
        return {**s, "lsym_eff": lsym_eff, "dcode_eff": dcode_eff, "lf_q": lf_q, "df_q": df_q,
                "l_freq_r": l_freq_r, "d_freq_r": d_freq_r}

    def scoring(self, s: dict) -> dict:
        """Every range's cost (exact tables and headers, or the entropy proxy;
        exact fixed), then the cheapest composition of ranges into blocks."""
        opt = self.options
        l_freq_r, d_freq_r, n = s["l_freq_r"], s["d_freq_r"], s["n"]
        out = {}
        fixed_l286 = self.fixed_l_len[: C.NUM_USED_LITLEN]
        fix_tok_bits_r = self._token_bits(l_freq_r, d_freq_r, fixed_l286, self.fixed_d_len)
        if opt.exact_split_scoring:
            # Optimal tables and exact headers for every range; the chosen
            # blocks then reuse them.
            l_len_r, d_len_r = self._code_lengths(l_freq_r, d_freq_r)
            hdr_r = self._headers(l_len_r, d_len_r)
            dyn_tok_bits_r = self._token_bits(l_freq_r, d_freq_r, l_len_r, d_len_r)
            dyn_score_r = 3 + hdr_r["bits"] + dyn_tok_bits_r
            out = {"l_len_r": l_len_r, "d_len_r": d_len_r, "hdr_r": hdr_r,
                   "dyn_tok_bits_r": dyn_tok_bits_r}
        else:
            lbits_p, lu, lz = proxy_bits(l_freq_r, self.proxy_table, self.proxy_offsets,
                                         float32_sums=self.proxy_float32)
            dbits_p, du, dz = proxy_bits(d_freq_r, self.proxy_table, self.proxy_offsets,
                                         float32_sums=self.proxy_float32)
            extra_bits_r = (l_freq_r * self.l_extra).sum(-1) + (d_freq_r * self.d_extra).sum(-1)
            proxy_hdr_r = 14 + 57 + 4 * (lu + du) + 8 * (lz + dz)
            dyn_score_r = 3 + proxy_hdr_r + lbits_p + dbits_p + extra_bits_r
        range_score = torch.minimum(dyn_score_r, 3 + fix_tok_bits_r)  # [B, R]

        force_fix = n <= 4
        if opt.special == SpecialOptions.ForceFixed:
            force_fix = torch.ones_like(force_fix)
        NC = len(self.sc.comps)
        comp_cost = (range_score[:, None, :] * self.comp_ranges).sum(-1)  # [B, C]
        not_first = torch.arange(NC, device=n.device) != 0
        comp_cost = torch.where(force_fix[:, None] & not_first, 1 << 30, comp_cost)
        best_comp = torch.argmin(comp_cost, dim=1)  # first minimum
        return {**s, **out, "force_fix": force_fix, "best_comp": best_comp,
                "is_split": best_comp != 0}

    def tables(self, s: dict) -> dict:
        """Exact Huffman tables of the chosen blocks (package_merge kernel),
        their headers and canonical clen codes, and the exact stored /
        fixed / dynamic choice (and the force modes)."""
        opt, E, nq = self.options, self.E, self.sc.nq
        n, best_comp, force_fix = s["n"], s["best_comp"], s["force_fix"]
        B, dev = n.shape[0], n.device
        NS = nq  # at most nq blocks
        exist = self.exist_c[best_comp]  # [B, NS]
        if opt.exact_split_scoring:
            # Each block's tables, header and bit costs are its range's
            # (a missing block selects range 0: inert, every use is gated
            # by ``exist`` or the quarter selectors).
            rid = self.rid_t_c[best_comp]  # [B, NS]
            l_freq_s = _gather_slots(s["l_freq_r"], rid)
            d_freq_s = _gather_slots(s["d_freq_r"], rid)
            l_len_s, d_len_s = _gather_slots(s["l_len_r"], rid), _gather_slots(s["d_len_r"], rid)
            hdr_s = {k: _gather_slots(v, rid) for k, v in s["hdr_r"].items()}
            dyn_tok_bits_s = _gather_slots(s["dyn_tok_bits_r"], rid)
        else:
            mem = self.mem_c[best_comp]  # [B, NS, nq]
            # (no integer matmul on CUDA: multiply and sum)
            l_freq_s = (mem[..., None] * s["lf_q"][:, None]).sum(dim=2)
            l_freq_s[:, :, C.END_OF_BLOCK] += exist
            d_freq_s = (mem[..., None] * s["df_q"][:, None]).sum(dim=2)
            l_len_s, d_len_s = self._code_lengths(l_freq_s, d_freq_s)
            hdr_s = self._headers(l_len_s, d_len_s)
            dyn_tok_bits_s = self._token_bits(l_freq_s, d_freq_s, l_len_s, d_len_s)
        fixed_l286 = self.fixed_l_len[: C.NUM_USED_LITLEN]
        fix_tok_bits_s = self._token_bits(l_freq_s, d_freq_s, fixed_l286, self.fixed_d_len)
        clen_codes_s = canonical_codes(
            hdr_s["clen_len"].reshape(B * NS, 19), C.MAX_CLEN_CODE_LENGTH).view(B, NS, 19)

        SB = C.MAX_STORED_BLOCK
        n_sub_static = max(1, (E + SB - 1) // SB)
        sub_k = torch.arange(n_sub_static, device=dev)
        sub_present = (n[:, None] > sub_k * SB) | (sub_k == 0)
        n_sub = sub_present.sum(dim=1)
        stored_bits = 40 * n_sub + 8 * n

        dyn_total_s = 3 + hdr_s["bits"] + dyn_tok_bits_s
        fix_total_s = 3 + fix_tok_bits_s
        # Fixed beats dynamic on ties (huffman_lengths.rs:271-286).
        s_is_fix = (fix_total_s <= dyn_total_s) | force_fix[:, None]
        slot_cost = torch.where(s_is_fix, fix_total_s, dyn_total_s)
        huff_total = (exist * slot_cost).sum(dim=1)
        whole_fix = s_is_fix[:, 0]
        is_split = s["is_split"]
        # Chunk-level tie order: fixed beats stored beats dynamic.
        is_stored = (stored_bits < huff_total) | (
            (stored_bits == huff_total) & ~(~is_split & whole_fix))
        is_stored = is_stored & ~force_fix
        if opt.special == SpecialOptions.ForceStored:  # after the force_fix mask
            is_stored = torch.ones_like(is_stored)
        btype = torch.where(
            is_stored, C.BTYPE_STORED,
            torch.where(is_split, C.BTYPE_SPLIT,
                        torch.where(whole_fix, C.BTYPE_FIXED, C.BTYPE_DYNAMIC)))
        return {**s, "l_len_s": l_len_s, "d_len_s": d_len_s, "hdr_s": hdr_s,
                "clen_codes_s": clen_codes_s, "s_is_fix": s_is_fix, "sub_k": sub_k,
                "sub_present": sub_present, "n_sub": n_sub, "is_stored": is_stored,
                "huff": ~is_stored, "data_bits": torch.where(is_stored, stored_bits, huff_total),
                "btype": btype}

    def fields(self, s: dict) -> dict:
        """Every field of the Huffman blocks in stream order: block headers,
        dynamic headers and the tokens (token_fields kernel), end of block."""
        nq = self.sc.nq
        QL = self.E // nq
        NL, ND, NLS = C.NUM_USED_LITLEN, C.NUM_DIST_SYMBOLS, C.NUM_LITLEN_SYMBOLS
        huff, s_is_fix, best_comp, hdr_s = s["huff"], s["s_is_fix"], s["best_comp"], s["hdr_s"]
        B, dev = huff.shape[0], huff.device
        NS = nq
        clen_len_s = hdr_s["clen_len"]
        l_len_sel_s = torch.where(s_is_fix[..., None], self.fixed_l_len,
                                  torch.nn.functional.pad(s["l_len_s"], (0, NLS - NL)))
        d_len_sel_s = torch.where(s_is_fix[..., None], self.fixed_d_len, s["d_len_s"])
        ld_codes = canonical_codes(
            torch.cat([l_len_sel_s, torch.nn.functional.pad(d_len_sel_s, (0, NLS - ND))],
                      dim=1).reshape(B * 2 * NS, NLS),
            C.MAX_CODE_LENGTH).view(B, 2 * NS, NLS)
        l_code_sel_s = ld_codes[:, :NS]
        d_code_sel_s = ld_codes[:, NS:, :ND]
        l_pack_s = l_code_sel_s | (l_len_sel_s << 16)
        d_pack_s = d_code_sel_s | (d_len_sel_s << 16)

        hdr_on_q = self.hdr_start_c[best_comp] == 1  # [B, nq]
        eob_on_q = self.blk_end_c[best_comp] == 1
        sid_q = self.slotq_c[best_comp]
        q_last = self.last_start[best_comp]

        t1v, t1b, t2v, t2b = token_fields(
            huff.int(), s["lsym_eff"], s["len_extra_n"].int(), s["len_extra_v"].int(),
            s["dcode_eff"], s["dist_extra_n"].int(), s["dist_extra_v"].int(),
            _gather_slots(l_pack_s, sid_q).int().contiguous(),
            _gather_slots(d_pack_s, sid_q).int().contiguous())

        part_fix = s_is_fix.gather(1, sid_q)
        hdr_on = huff[:, None] & hdr_on_q
        dyn_on = hdr_on & ~part_fix
        bt_bits = torch.where(part_fix, C.BTYPE_FIXED, C.BTYPE_DYNAMIC)
        qidx = torch.arange(nq, device=dev)
        bf = torch.where(qidx == q_last[:, None], s["is_last"].long()[:, None], 0)
        hdr_v = (bf | (bt_bits << 1))[..., None]
        hdr_b = torch.where(hdr_on, 3, 0)[..., None]

        hlit_q = hdr_s["hlit"].gather(1, sid_q)
        hclen_q = hdr_s["hclen"].gather(1, sid_q)
        dh_v = torch.stack([hlit_q - 257, hdr_s["hdist"].gather(1, sid_q) - 1, hclen_q - 4],
                           dim=-1)
        dh_b = torch.where(dyn_on[..., None], self.dh_bits, 0)
        co_v = _gather_slots(clen_len_s[..., self.clen_order], sid_q)
        co_b = torch.where(dyn_on[..., None] & (torch.arange(19, device=dev) < hclen_q[..., None]), 3, 0)
        j = torch.arange(CL_CAP, device=dev)
        rle_sym = _gather_slots(hdr_s["sym"], sid_q)
        rle_code_v = _gather_slots(s["clen_codes_s"], sid_q).gather(-1, rle_sym)
        rle_on = (j < _gather_slots(hdr_s["n"], sid_q)[..., None]) & dyn_on[..., None]
        rle_code_b = torch.where(rle_on, _gather_slots(clen_len_s, sid_q).gather(-1, rle_sym), 0)
        rle_ex_v = _gather_slots(hdr_s["extra_vals"], sid_q)
        rle_ex_b = torch.where(dyn_on[..., None], _gather_slots(hdr_s["extra_bits"], sid_q), 0)
        rle_v = torch.stack([rle_code_v, rle_ex_v], dim=-1).view(B, nq, 2 * CL_CAP)
        rle_b = torch.stack([rle_code_b, rle_ex_b], dim=-1).view(B, nq, 2 * CL_CAP)

        tok_v = torch.stack([t1v.long() & 0xFFFFFFFF, t2v.long() & 0xFFFFFFFF],
                            dim=-1).view(B, nq, 2 * QL)
        tok_b = torch.stack([t1b.long(), t2b.long()], dim=-1).view(B, nq, 2 * QL)

        eob_v = _gather_slots(l_code_sel_s[..., C.END_OF_BLOCK], sid_q)[..., None]
        eob_b = torch.where(huff[:, None] & eob_on_q,
                            _gather_slots(l_len_sel_s[..., C.END_OF_BLOCK], sid_q), 0)[..., None]

        return {**s,
                "seg_v": torch.cat([hdr_v, dh_v, co_v, rle_v, tok_v, eob_v], dim=-1).reshape(B, -1),
                "seg_b": torch.cat([hdr_b, dh_b, co_b, rle_b, tok_b, eob_b], dim=-1).reshape(B, -1)}

    def pack(self, s: dict) -> dict:
        """The stored sub-blocks' fields and the sync-flush marker after the
        Huffman fields, bit-packed into words."""
        E = self.E
        n, is_last, is_stored, data_bits = s["n"], s["is_last"], s["is_stored"], s["data_bits"]
        sub_k, sub_present, n_sub = s["sub_k"], s["sub_present"], s["n_sub"]
        B, dev = n.shape[0], n.device
        SB = C.MAX_STORED_BLOCK
        # Stored sub-blocks: hdr(3) + pad(5) + LEN + NLEN + payload words.
        sub_len = (n[:, None] - sub_k * SB).clamp(0, SB)
        last_sub = (n_sub - 1).clamp(min=0)
        sub_final = (sub_k == last_sub[:, None]) & is_last[:, None]
        st_v, st_b = [], []
        if self.stored_payload_fields:
            p = pack_words_aligned(s["bufs"][:, HALO : HALO + E])
            wj = torch.arange(E // 4, device=dev)
            pb_b_all = 8 * (n[:, None] - 4 * wj).clamp(0, 4)
        for k in range(sub_k.shape[0] if self.stored_payload_fields else 0):
            on = (is_stored & sub_present[:, k])[:, None]
            st_v.append(torch.stack([sub_final[:, k].long(), torch.zeros_like(n),
                                     sub_len[:, k], (~sub_len[:, k]) & 0xFFFF], dim=-1))
            st_b.append(torch.where(on, self.sh_bits, 0))
            lo, hi = k * SB // 4, min((k + 1) * SB, E) // 4
            st_v.append(p[:, lo:hi])
            st_b.append(torch.where(on, pb_b_all[:, lo:hi], 0))

        # Sync-flush marker for non-final chunks (compress.rs:257-262).
        sync_pad = (-(data_bits + 3)) % 8
        sy_v = self.sy_vals.expand(B, 4)
        sy_b = torch.where(
            ~is_last[:, None],
            torch.stack([torch.full_like(sync_pad, 3), sync_pad,
                         torch.full_like(sync_pad, 16), torch.full_like(sync_pad, 16)], dim=-1),
            0)

        values = torch.cat([s["seg_v"], *st_v, sy_v], dim=1)
        nbits = torch.cat([s["seg_b"], *st_b, sy_b], dim=1)
        words, total_bits = pack_fields(values, nbits, self.num_words)
        if not self.stored_payload_fields:
            # Stored chunks packed no fields: their exact size comes from the
            # cost model, data_bits plus the sync marker as for Huffman chunks.
            sync_bits = torch.where(is_last, 0, 3 + sync_pad + 32)
            total_bits = torch.where(is_stored, data_bits + sync_bits, total_bits)
        return {**s, "words": words, "total_bits": total_bits}

    def checksums(self, s: dict) -> dict:
        """With ``with_checksums``: each payload's Adler-32 and raw CRC-32
        partials."""
        if not self.with_checksums:
            return s
        payload, n = s["bufs"][:, HALO : HALO + self.E], s["n"]
        s1, s2 = adler32_parts_device(payload, n)
        return {**s, "s1": s1, "s2": s2,
                "crc_raw": crc32_raw_device(payload, n, self.crc_table, self.crc_shift_tables)}


def pack_words_aligned(payload: torch.Tensor) -> torch.Tensor:
    """Little-endian 32-bit words of ``payload`` uint8[B, 4W] at stride 4."""
    p = payload.long()
    return p[:, 0::4] | (p[:, 1::4] << 8) | (p[:, 2::4] << 16) | (p[:, 3::4] << 24)
