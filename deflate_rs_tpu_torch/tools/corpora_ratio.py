"""Default against zlib -6 and high against zlib -9 on real corpora, 256 KiB.

The torch form of ``scripts/corpora_ratio.py``, over the ten corpus classes
of ``tools/corpora.py`` (the JAX script read a narrower set of its own) at
256 KiB each: one table row per class with its size, Default's size beside
zlib -6's, high's beside zlib -9's, whether each holds the contract and the
margins, then the classes skipped.  The rows come from
``contract_margins.margin_rows``; every stream round-trips through ``zlib``.

    python3 -m deflate_rs_tpu_torch.tools.corpora_ratio
    python3 -m deflate_rs_tpu_torch.tools.corpora_ratio --device cpu
"""

from __future__ import annotations

import argparse
import sys

import torch

from .contract_margins import margin_rows

CAP_KIB = 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("corpora_ratio: no CUDA device (pass --device cpu for the CPU)", file=sys.stderr)
        return 1
    rows, skipped = margin_rows([CAP_KIB], device=a.device)
    by = {(r["preset"], r["class"]): r for r in rows}
    print(f"{'corpus':10s} {'bytes':>8s} {'default':>9s} {'zlib-6':>9s} {'ok':>3s} "
          f"{'margin':>8s} {'high':>9s} {'zlib-9':>9s} {'ok':>3s} {'margin':>8s}")
    for name in sorted({c for _, c in by}):
        d, h = by["default", name], by["high", name]
        print(f"{name:10s} {d['bytes']:8d} {d['ours']:9d} {d['zlib6']:9d} "
              f"{'Y' if d['ours'] <= d['zlib6'] else 'N':>3s} {d['margin']:+8.4f} "
              f"{h['ours']:9d} {h['zlib9']:9d} {'Y' if h['ours'] <= h['zlib9'] else 'N':>3s} "
              f"{h['margin']:+8.4f}", flush=True)
    print(f"skipped (no files on this machine): {skipped or 'none'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
