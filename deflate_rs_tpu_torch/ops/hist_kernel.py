"""Per-quarter symbol histograms: CUDA kernel + plain twin.

Replaces the Pallas kernel ``deflate_rs_tpu/ops/hist_kernel.py::_kernel``
(entry ``quarter_histograms_batched``).  For chunk ``b`` and quarter ``q``
(positions ``q*QL .. (q+1)*QL`` of the emit region, ``QL = E / nq``) it
counts the litlen symbols over 286 bins and the distance codes over 30
bins.  A value outside its bin range counts nowhere: the encoder marks
non-token positions with 999 (litlen) and non-match positions with 99
(distance).

:func:`quarter_histograms_plain` is a ``scatter_add`` over
``quarter * bins + value``; :func:`quarter_histograms` runs the CUDA kernel
(``csrc/quarter_hist.cu``) on a CUDA tensor and the plain version on a CPU
one.  Counts are integers, so the two are equal exactly.
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime import cuda

NBINS_L = 286
NBINS_D = 30

_KERNEL = cuda.register("quarter_hist", [
    ctypes.c_void_p, ctypes.c_void_p,                # lsym_eff, dcode_eff
    ctypes.c_int, ctypes.c_int, ctypes.c_int,        # B, E, nq
    ctypes.c_void_p, ctypes.c_void_p,                # lf, df
])


def _counts(sym: torch.Tensor, nq: int, nbins: int) -> torch.Tensor:
    B, E = sym.shape
    q = torch.arange(E, device=sym.device) // (E // nq)
    ok = (sym >= 0) & (sym < nbins)
    flat = q * nbins + sym.long().clamp(0, nbins - 1)
    out = torch.zeros((B, nq * nbins), dtype=torch.int64, device=sym.device)
    return out.scatter_add_(1, flat, ok.long()).view(B, nq, nbins).int()


def quarter_histograms_plain(lsym_eff: torch.Tensor, dcode_eff: torch.Tensor, nq: int):
    """Plain PyTorch version of :func:`quarter_histograms` (same outputs)."""
    return _counts(lsym_eff, nq, NBINS_L), _counts(dcode_eff, nq, NBINS_D)


def quarter_histograms(lsym_eff: torch.Tensor, dcode_eff: torch.Tensor, nq: int):
    """Per-quarter litlen and distance histograms of a batch of chunks.

    Args:
      lsym_eff: int32[B, E] litlen symbols; a value outside [0, 286)
        counts nowhere.
      dcode_eff: int32[B, E] distance codes; a value outside [0, 30) counts
        nowhere.
      nq: quarters per chunk (divides E).

    Returns (lf int32[B, nq, 286], df int32[B, nq, 30]).
    """
    if not lsym_eff.is_cuda:
        return quarter_histograms_plain(lsym_eff, dcode_eff, nq)
    B, E = lsym_eff.shape
    if nq < 1 or E % nq or B == 0:
        raise ValueError(f"quarter_hist: unsupported shape B={B}, E={E}, nq={nq}")
    cuda.check_cuda(lsym_eff, "lsym_eff", torch.int32, (B, E))
    cuda.check_cuda(dcode_eff, "dcode_eff", torch.int32, (B, E))
    # One allocation for both outputs: where the kernel splits a quarter over
    # several blocks it zeroes them with a single memset before the launch.
    flat = torch.empty(B * nq * (NBINS_L + NBINS_D), dtype=torch.int32, device=lsym_eff.device)
    lf = flat[: B * nq * NBINS_L].view(B, nq, NBINS_L)
    df = flat[B * nq * NBINS_L :].view(B, nq, NBINS_D)
    _KERNEL(lsym_eff.device, lsym_eff.data_ptr(), dcode_eff.data_ptr(), B, E, nq,
            lf.data_ptr(), df.data_ptr())
    return lf, df
