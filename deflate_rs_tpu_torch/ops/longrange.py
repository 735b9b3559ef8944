"""Long-range match recovery: exact lengths at locally dominant distances.

Port of ``deflate_rs_tpu/ops/longrange.py``:

1. HARVEST: positions whose matcher claim hit the probe cap contribute their
   distance (``d_cand``): pair-collapsed (the presets), or every
   ``harvest_stride``-th position (the ``lr_stride > 1`` knob).
2. DOMINANTS (:func:`select_dominants`): each of ``S`` segments keeps its
   top ``M`` distances, ranked by longest contiguous run (``sel="run"``,
   Default) or by total count (``sel="freq"``, high), live ones as a prefix
   of the row.  The ``lr_global`` knob then unions them into one list a
   chunk (:func:`union_dominants`).
3. MEASURE (``ops/lr_kernel.py``): the word-space run at every dominant, per
   segment (:func:`local_dominant_lengths`) or over the whole chunk as one
   segment (:func:`global_dominant_lengths`), the CUDA kernel on the card
   and its plain twin on the CPU.
4. EXPAND (:func:`finish_from_winner`): per-word winners become
   per-position claims, never overclaiming.
"""

from __future__ import annotations

import torch

from ..constants import MAX_MATCH
from .lr_kernel import lr_measure
from .matching import matched_low_bytes


def select_dominants(d_cand: torch.Tensor, S: int, M: int, sel: str = "run", *,
                     harvest_stride: int = 1, pair: bool = True):
    """Per-segment top-M harvested distances ``[B, S, M]`` (0 = dead slot),
    and their counts.

    The harvest is pair-collapsed (``pair=True``: a pair of positions keeps
    the even one's distance, else the odd one's) or subsampled at every
    ``harvest_stride``-th position.  ``sel="run"`` ranks a distance by its
    longest contiguous run in position order, then drops the lower-ranked
    duplicates; ``sel="freq"`` ranks it by its total count, from runs of the
    value-sorted row (each value is one run, so nothing needs dropping).
    Live dominants form a count-descending prefix of each row, ties to the
    larger distance."""
    if sel not in ("run", "freq"):
        raise ValueError(f"unknown dominant selection {sel!r}")
    B = d_cand.shape[0]
    dc0 = d_cand.reshape(B, S, -1).long()
    if pair:
        assert harvest_stride == 1, "pair collapse replaces the stride"
        even, odd = dc0[..., 0::2], dc0[..., 1::2]
        rows = torch.where(even != 0, even, odd)
    else:
        rows = dc0[..., ::harvest_stride]
    if sel == "freq":
        rows = torch.sort(rows, dim=-1).values
    LC = rows.shape[-1]
    if LC >= (1 << 15):
        raise ValueError(
            f"dominant-selection row width {LC} >= 2^15 overflows the "
            "packed freq<<16 sort; raise dom_segs or harvest_stride")
    dev = rows.device
    ii = torch.arange(LC, device=dev)
    ones = torch.ones((B, S, 1), dtype=torch.bool, device=dev)
    change = torch.cat([ones, rows[..., 1:] != rows[..., :-1]], dim=-1)
    start = torch.cummax(torch.where(change, ii, 0), dim=-1).values
    nxt_change = torch.cat([change[..., 1:], ones], dim=-1)
    end = torch.cummin(torch.where(nxt_change, ii + 1, LC).flip(-1), dim=-1).values.flip(-1)
    freq = torch.where(change & (rows > 0), end - start, 0)
    packed = (freq << 16) | rows
    top = torch.sort(packed, dim=-1, descending=True).values[..., :M]
    if top.shape[-1] < M:
        top = torch.nn.functional.pad(top, (0, M - top.shape[-1]))
    if sel == "run":
        # Dedup: keep a distance's highest-ranked slot only, then re-compact
        # so the live dominants stay a prefix.
        v = top & 0xFFFF
        earlier = torch.ones((M, M), dtype=torch.bool, device=dev).tril(diagonal=-1)
        dup = ((v[..., :, None] == v[..., None, :]) & earlier).any(dim=-1)
        top = torch.where(dup, 0, top)
        top = torch.sort(top, dim=-1, descending=True).values
    topf = top >> 16
    return torch.where(topf > 0, top & 0xFFFF, 0).int(), topf.int()


def union_dominants(d_cand: torch.Tensor, num_seg: int, num_dom: int, num_global: int, *,
                    harvest_stride: int = 1, sel: str = "run", pair: bool = True):
    """One list of ``num_global`` distances a chunk, int32 ``[B, D]`` (0 =
    dead): the union of the per-segment selections of
    :func:`select_dominants`, ranked by total frequency.

    The S x M (distance, count) pairs are sorted by distance, the counts
    summed over each run of equal distances, and the ``min(D, S * M)`` runs
    of the largest totals kept, then zeros up to D.  Ties: among equal
    totals the smaller distance comes first (``jax.lax.top_k`` keeps the
    lower index, and the runs lie in ascending distance), so a stable
    descending sort of the totals gives JAX's list.  Live distances form a
    total-descending prefix, as the measurement's loop bound wants."""
    S, M, D = num_seg, num_dom, num_global
    doms, topf = select_dominants(d_cand, S, M, sel, harvest_stride=harvest_stride, pair=pair)
    B = doms.shape[0]
    flat_v = doms.reshape(B, -1).long()
    flat_f = torch.where(flat_v > 0, topf.reshape(B, -1).long(), 0)
    v, order = torch.sort(flat_v, dim=-1, stable=True)
    g = torch.cumsum(flat_f.gather(1, order), dim=-1)
    ones = torch.ones((B, 1), dtype=torch.bool, device=v.device)
    change = torch.cat([ones, v[:, 1:] != v[:, :-1]], dim=-1)
    gprev = torch.nn.functional.pad(g[:, :-1], (1, 0))
    base_g = torch.cummax(torch.where(change, gprev, 0), dim=-1).values
    last = torch.cat([change[:, 1:], ones], dim=-1)
    runtot = torch.where(last & (v > 0), g - base_g, 0)  # at each run's last row
    tot, idx = torch.sort(runtot, dim=-1, descending=True, stable=True)
    tot, idx = tot[:, : min(D, S * M)], idx[:, : min(D, S * M)]
    dlist = torch.where(tot > 0, v.gather(1, idx), 0)
    return torch.nn.functional.pad(dlist, (0, D - dlist.shape[1])).int()


def finish_from_winner(run_w, dist_w, xor_n, N: int, n_total, hstart):
    """O(N) byte expansion of per-word winners into per-position claims.

    ``run_w``/``dist_w``/``xor_n`` are the ``[B, S, LW]`` outputs of
    ``lr_measure``; returns (best_len, best_dist) int32[B, N]."""
    B, S, _ = run_w.shape
    LQ = N // S // 4
    dev = run_w.device
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    nt = n_total.int()[:, None]
    limit = (nt - idx).clamp(0, MAX_MATCH)

    def up4(a):
        return a.repeat_interleave(4, dim=-1).reshape(B, N)

    len0 = up4(run_w[..., :LQ])
    d0 = up4(dist_w[..., :LQ])
    rn = up4(run_w[..., 1 : LQ + 1])
    dn = up4(dist_w[..., 1 : LQ + 1])
    xq = up4(xor_n[..., :LQ])
    o = idx & 3
    tail = torch.where(o > 0, xq >> (8 * o), 1)
    eo = torch.minimum(matched_low_bytes(tail), 4 - o)
    len_o = eo + torch.where(eo == 4 - o, rn.clamp(min=0), 0)
    b_len = torch.where(o == 0, len0.clamp(min=0), len_o)
    b_dist = torch.where(o == 0, d0, dn)
    b_len = torch.minimum(b_len, limit)
    ok = ((b_len >= 3) & (b_dist > 0) & (idx - b_dist >= hstart.int()[:, None])
          & (idx < nt))
    return torch.where(ok, b_len, 0), torch.where(ok, b_dist, 0)


def local_dominant_lengths(buf, N: int, n_total, hstart, d_cand, *, num_dom: int,
                           num_seg: int, sel: str = "run", harvest_stride: int = 1,
                           pair: bool = True):
    """Per-position match lengths at each segment's dominant distances.

    Args:
      buf: uint8[B, N + PAD] chunk buffers.
      d_cand: int32[B, N] harvested distances (0 = none).
      sel, harvest_stride, pair: dominant selection, see
        :func:`select_dominants`.

    Returns (best_len, best_dist): int32[B, N], 0 where no claim.
    """
    if N % (4 * num_seg):
        raise ValueError(f"N={N} must divide by 4 * num_seg={4 * num_seg}")
    doms, _ = select_dominants(d_cand, num_seg, num_dom, sel, harvest_stride=harvest_stride,
                               pair=pair)
    run_w, dist_w, xor_n = lr_measure(buf, doms.contiguous(), N)
    return finish_from_winner(run_w, dist_w, xor_n, N, n_total, hstart)


def global_dominant_lengths(buf, N: int, n_total, hstart, d_cand, *, num_dom: int,
                            num_seg: int, num_global: int, sel: str = "run",
                            harvest_stride: int = 1, pair: bool = True):
    """Per-position match lengths at the chunk's unioned dominant distances.

    The ``lr_global`` form of :func:`local_dominant_lengths`: the
    :func:`union_dominants` list is measured over the WHOLE chunk, as one
    segment holding all ``num_global`` slots (``lr_measure`` at S = 1,
    M = D), a superset of the per-segment claims.  Same arguments and
    returns, plus ``num_global`` (D)."""
    if N % 4:
        raise ValueError(f"N={N} must divide by 4")
    dlist = union_dominants(d_cand, num_seg, num_dom, num_global, harvest_stride=harvest_stride,
                            sel=sel, pair=pair)
    run_w, dist_w, xor_n = lr_measure(buf, dlist[:, None, :].contiguous(), N)
    return finish_from_winner(run_w, dist_w, xor_n, N, n_total, hstart)
