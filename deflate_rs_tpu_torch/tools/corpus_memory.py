"""Device memory and speed of the corpus engine by chunk size and batch.

For each preset, chunk size and batch size given, runs ``compress_corpus``
over the first ``batch * chunk`` bytes of ``chip_smoke.py``'s mix (at least
one full batch; a batch size of 0 is the engine's default at that chunk
size, ``corpus.default_batch_size``: 64 chunks, or 64 MiB of payload above
1 MiB, 4 chunks of 16 MiB) and prints one JSON line: the peak of
``torch.cuda.max_memory_allocated()`` during a run (GiB), the card's total
memory, warm MB/s of two runs and the compressed ratio.  The configurations
run in the order given, so list the largest last: a batch that does not fit
fails the run where it stands, with the lines before it printed.  Run from
the repository root on a machine with one NVIDIA GPU:

    python3 -m deflate_rs_tpu_torch.tools.corpus_memory \\
        --chunk-kb 256 512 1024 --batch-sizes 1 4 16 64 --presets default high
    python3 -m deflate_rs_tpu_torch.tools.corpus_memory --chunk-kb 2048 4096 16384 \\
        --batch-sizes 0 --presets fast rle
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def measure(data: bytes, options, chunk_size: int, batch_size: int | None, device) -> dict:
    """Peak memory, warm MB/s and ratio of ``compress_corpus`` on ``data``
    (``batch_size`` None: the engine's default)."""
    import torch

    from ..parallel.corpus import compress_corpus

    def run():
        return compress_corpus(data, options, batch_size=batch_size, chunk_size=chunk_size,
                               device=device)

    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    out = run()  # warm: the peak of the first run counts its buffers too
    walls = []
    for _ in range(2):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
    return {"peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
            "mb_per_s": [len(data) / 1e6 / w for w in walls],
            "ratio": len(out.deflate) / len(data), "batches": out.fetched["batches"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunk-kb", type=int, nargs="+", default=[256, 512, 1024],
                    help="chunk sizes in KiB, up to 4,096")
    ap.add_argument("--batch-sizes", type=int, nargs="+", default=[1, 4, 16],
                    help="chunks a batch; 0 is the engine's default at each chunk size")
    ap.add_argument("--presets", nargs="+", default=["default"])
    a = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("corpus_memory: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import deflate_rs_tpu_torch as dt
    from deflate_rs_tpu_torch.parallel.corpus import default_batch_size
    from deflate_rs_tpu_torch.utils.mix import build_mix, pg11

    def chunks(E: int, bs: int) -> int:
        return bs or default_batch_size(E)

    dev = torch.device("cuda", 0)
    total = torch.cuda.get_device_properties(dev).total_memory / 2**30
    largest = max(kb * 1024 * chunks(kb * 1024, bs) for kb in a.chunk_kb for bs in a.batch_sizes)
    mix = build_mix(largest, pg11())
    for preset in a.presets:
        opts = getattr(dt.CompressionOptions, preset)()
        for kb in a.chunk_kb:
            for bs in a.batch_sizes:
                E = kb * 1024
                row = {"preset": preset, "chunk_size": E, "batch_size": chunks(E, bs),
                       "default_batch": not bs, "total_gib": total}
                row.update(measure(mix[: E * chunks(E, bs)], opts, E, bs or None, dev))
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
