"""Used-prefix compaction: the single definition of the fetch contract.

Port of ``deflate_rs_tpu/ops/compaction.py``.  The device-to-host fetch moves
only the words the host splicer reads: ``ceil(data_bits / 32)`` words of a
Huffman chunk and none of a stored chunk, which the host re-emits from the raw
bytes it already holds (models/assembly.py).  The corpus engine and the
streaming encoders' batched path share this rule; it lives here once, so the
device-side packing and every host-side reader cannot drift apart.

Device side: an exclusive prefix sum of the used counts gives each chunk's
place in one flat buffer, and one scatter moves every used word there (the
JAX package packs by a sort on the same destination index, a scatter being
costly on its device).  Unused words all land on one spare slot past the
buffer.  The flat buffer is 32-bit, ``int32`` holding the uint32 pattern, not
the encoder's int64 carrier: the host views it as bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C


def used_words_host(btype, data_bits):
    """Words the host splicer reads per chunk (NumPy, host side)."""
    return np.where(np.asarray(btype) == C.BTYPE_STORED, 0,
                    (np.asarray(data_bits) + 31) // 32)


def used_words_device(btype: torch.Tensor, data_bits: torch.Tensor) -> torch.Tensor:
    """Words the device packs per chunk: the same rule on tensors."""
    return torch.where(btype == C.BTYPE_STORED, 0, (data_bits + 31) // 32)


def compact_words_device(words: torch.Tensor, used: torch.Tensor) -> torch.Tensor:
    """Pack each chunk's ``used`` word prefix into one flat 32-bit buffer.

    Args:
      words: int[B, NW] per-chunk output word rows (uint32 values in any
        integer type).
      used:  int[B] words to keep per chunk (the rule above).

    Returns int32[B * NW]: chunk i's kept words at ``cumsum_excl(used)[i]``;
    everything past ``used.sum()`` is undefined filler.
    """
    B, NW = words.shape
    used = used.long()
    woff = torch.cumsum(used, dim=0) - used
    j = torch.arange(NW, device=words.device)
    dest = torch.where(j < used[:, None], woff[:, None] + j, B * NW)
    flat = torch.empty(B * NW + 1, dtype=torch.int32, device=words.device)
    flat.scatter_(0, dest.reshape(-1), words.to(torch.int32).reshape(-1))
    return flat[: B * NW]
