"""The parse: token-start mask of each chunk.  CUDA kernel + plain twin.

Replaces the Pallas kernel ``deflate_rs_tpu/ops/parse_scan.py::_kernel``
(entry ``parse_scan_batched``).  The sequential parse of a chunk is the
orbit of position 0 under ``next[i] = i + steps[i]``, cut at the payload
length ``n``.  The CUDA kernel (``csrc/parse_scan.cu``) cuts the chunk into
segments of 64 positions, one thread each, the last one partial where the
width is no multiple of 64 (a chunk wider than 65,536 positions in windows
of that width, one after the other): every segment parses
hypothetically from its own first position, then again, speculatively, from
the previous segment's hypothesis exit until it meets a hypothesis token
(after which the two parses coincide); one thread then repairs, serially,
only the stretches that follow a segment whose assumed entry proved wrong.
:func:`parse_scan_plain` computes the same mask by pointer doubling
(``parse.reachable``).
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime import cuda
from .parse import reachable

_KERNEL = cuda.register("parse_scan", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # steps, n, B, E
    ctypes.c_void_p,                                                 # out
])


def parse_scan_plain(steps: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`parse_scan` (same output)."""
    B, E = steps.shape
    dev = steps.device
    pos = torch.arange(E, device=dev)
    nxt = torch.minimum(pos + steps.long(), torch.tensor(E, device=dev))
    nxt = torch.nn.functional.pad(nxt, (0, 1), value=E)
    reach = reachable(nxt, 0)
    return reach[:, :E] & (pos < n.long()[:, None])


def parse_scan(steps: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Token-start mask bool[B, E] of the parse from position 0.

    Args:
      steps: int32[B, E] jump steps (1 literal, match length otherwise;
        1 <= steps <= 258); E a multiple of 16, as the Pallas kernel's.
      n: int32[B] payload lengths (tokens only at positions < n).
    """
    if not steps.is_cuda:
        return parse_scan_plain(steps, n)
    B, E = steps.shape
    if E <= 0 or E % 16:
        raise ValueError(f"parse_scan: unsupported chunk width E={E}")
    cuda.check_cuda(steps, "steps", torch.int32, (B, E))
    cuda.check_cuda(n, "n", torch.int32, (B,))
    out = torch.empty((B, E), dtype=torch.bool, device=steps.device)
    _KERNEL(steps.device, steps.data_ptr(), n.data_ptr(), B, E, out.data_ptr())
    return out
