"""Arithmetic length/distance code mapping.

Port of ``deflate_rs_tpu/ops/symbolmap.py``.  DEFLATE code ranges are
power-of-two buckets, so the code index is a function of the value's bit
length, read exactly from the float32 exponent (values < 2**24).  The JAX
package's one-hot ``histogram_onehot`` and ``table_lookup`` become the
quarter histograms of ``ops/hist_kernel.py`` and direct indexing in
``ops/field_kernel.py``.
"""

from __future__ import annotations

import torch


def bitlen(x: torch.Tensor) -> torch.Tensor:
    """Number of significant bits of x (x in [1, 2**24))."""
    return (x.float().view(torch.int32) >> 23).long() - 126


def length_code(length: torch.Tensor):
    """(code 0..28, extra_bits, extra_value) for match length 3..258."""
    l = length - 3
    lc = l.clamp(min=1)
    e = (bitlen(lc) - 3).clamp(min=0)
    small = l < 8
    is258 = length >= 258
    code = torch.where(small, l, (e << 2) + (lc >> e))
    code = torch.where(is258, torch.full_like(code, 28), code)
    extra_n = torch.where(small | is258, torch.zeros_like(e), e)
    base = torch.where(small | is258, length, ((4 + (code & 3)) << e) + 3)
    return code, extra_n, length - base


def dist_code(d: torch.Tensor):
    """(code 0..29, extra_bits, extra_value) for distance 1..32768."""
    dm = d - 1
    dc = dm.clamp(min=1)
    bsr = bitlen(dc) - 1
    small = dm < 4
    sh = (bsr - 1).clamp(min=0)
    code = torch.where(small, dm, 2 * bsr + ((dc >> sh) & 1))
    extra_n = torch.where(small, torch.zeros_like(bsr), bsr - 1)
    base_m1 = torch.where(small, dm, (2 + (code & 1)) << sh)
    return code, extra_n, dm - base_m1
