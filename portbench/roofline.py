"""Peaks of the card and the least bytes each hand-written kernel moves.

A kernel's bound is each of its operands' bytes read once and each of its
outputs' written once, over the card's memory bandwidth: the arithmetic of
``chip_smoke.py``'s ``bound_of``, taken here from the operands' shapes,
which follow from the cell's configuration.  The bytes belong to the
operation, so another kernel that does the same work is held to the same
bound.  Each function gives ``(bytes, launches)`` of one batch of ``B``
chunks of ``E`` bytes.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, 80 GB HBM3

HALO = 32768  # history bytes before a chunk
PAD = 72  # tail padding of a chunk's buffer
MAX_MATCH = 258
NSYM_L, NSYM_D = 288, 30  # token_fields' code tables
NBINS_L, NBINS_D = 286, 30  # quarter_hist's bins
PM_SYMBOLS = (286, 19)  # package-merge's alphabets: litlen, code lengths


def lr_measure(B: int, E: int, p: dict) -> tuple:
    """buf uint8[B, N + PAD], doms int32[B, S, M] in; run, dist int32 and
    xor int64 [B, S, LW] out (``ops/lr_kernel.py``)."""
    N, S, M = HALO + E, p["dom_segs"], p["num_dom"]
    LW = (N // S + MAX_MATCH + 6) // 4 + 1
    return B * (N + PAD) + 4 * B * S * M + 16 * B * S * LW, 1


def parse_scan(B: int, E: int, p: dict) -> tuple:
    """steps int32[B, E], n int32[B] in; bool[B, E] out."""
    return 5 * B * E + 4 * B, 1


def package_merge(B: int, E: int, p: dict) -> tuple:
    """Two launches a batch, int32 leaves in and lengths out: the litlen
    rows of every range the split scores (2 x quarters a chunk) and the
    code-length rows (one a quarter)."""
    nq = p["num_quarters"]
    rows = (2 * B * nq, B * nq)
    return sum(8 * r * a for r, a in zip(rows, PM_SYMBOLS)), 2


def token_fields(B: int, E: int, p: dict) -> tuple:
    """huff int32[B], six int32[B, E] and the packed tables int32[B, nq,
    288 + 30] in; four int32[B, E] out."""
    nq = p["num_quarters"]
    return 4 * B + 40 * B * E + 4 * B * nq * (NSYM_L + NSYM_D), 1


def quarter_hist(B: int, E: int, p: dict) -> tuple:
    """lsym, dcode int32[B, E] in; int32[B, nq, 286 + 30] out."""
    nq = p["num_quarters"]
    return 8 * B * E + 4 * B * nq * (NBINS_L + NBINS_D), 1


# The program's kernel counters (``runtime/cuda.py``), the operation each
# one launches, and the names of its ``__global__`` functions in the trace.
KERNELS = {
    "lr_measure": (lr_measure, ("lr_measure_kernel",)),
    "lr_measure_tiled": (lr_measure, ("lr_tile_first_kernel", "lr_tile_walk_kernel",
                                      "lr_tile_finish_kernel")),
    "parse_scan": (parse_scan, ("parse_scan_kernel",)),
    "package_merge": (package_merge, ("package_merge_kernel",)),
    "token_fields": (token_fields, ("token_fields_kernel",)),
    "quarter_hist": (quarter_hist, ("quarter_hist_kernel",)),
}


def bound_seconds(launches: dict, config: dict) -> float:
    """The least time the counted launches need at the configuration's
    batch and chunk size: bytes per launch times launches, over the
    bandwidth."""
    B, E, p = config["batch_size"], config["chunk_size"], config["preset_numbers"]
    total = 0.0
    for counter, n in launches.items():
        if counter in KERNELS and n:
            nbytes, per_batch = KERNELS[counter][0](B, E, p)
            total += n * nbytes / per_batch
    return total / HBM_BYTES_PER_S
