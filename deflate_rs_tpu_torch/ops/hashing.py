"""Position hashing for the hash matcher, batched over chunks.

Port of ``deflate_rs_tpu/ops/hashing.py``: the closed form of the
reference's rolling 3-byte hash (chained_hash_table.rs:55-62).  A stable
sort of positions by this hash puts, right above each position, the most
recent earlier positions with the same hash: the reference's hash chain.
"""

from __future__ import annotations

import torch

from ..constants import HASH_MASK

# Sort key of positions that cannot start a match: above every real hash, so
# they sort to the end and never interleave with real buckets.
INVALID_KEY = HASH_MASK + 1


def hash3(data: torch.Tensor, n_positions: int) -> torch.Tensor:
    """``((d[i] << 10) ^ (d[i+1] << 5) ^ d[i+2]) & 0x7FFF`` at every position.

    Args:
      data: uint8[B, >= n_positions + 2].

    Returns int32[B, n_positions] in [0, 0x8000).
    """
    d = data.int()
    n = n_positions
    return ((d[:, :n] << 10) ^ (d[:, 1 : n + 1] << 5) ^ d[:, 2 : n + 2]) & HASH_MASK
