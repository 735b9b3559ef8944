"""Where a corpus run's wall time goes on the card.

Profiles one warm run of each engine over ``chip_smoke.py``'s 16 MiB mix with
``torch.profiler`` and prints one JSON object per engine: the wall time, the
number of device activities (kernels, copies, memsets), the time the device
was busy (the union of their intervals), its idle share, and for the corpus
engine the host time inside each of its five ranges (``corpus.upload``,
``corpus.encode``, ``corpus.meta_fetch``, ``corpus.words_fetch``,
``corpus.splice``; ``DEFLATE_TPU_TRACE_CORPUS=1`` is set here).  Run from the
repository root on a machine with one NVIDIA GPU:

    python3 -m deflate_rs_tpu_torch.tools.corpus_profile [--batch-size N] [--queue-depth N]

Profiling slows the host, which bounds these runs, so the walls here are
longer than the unprofiled ones the script prints first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _busy_us(intervals: list) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(intervals):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    return busy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--queue-depth", type=int, default=None)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("corpus_profile: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    os.environ["DEFLATE_TPU_TRACE_CORPUS"] = "1"
    import deflate_rs_tpu_torch as dt
    from deflate_rs_tpu_torch.models.deflate import compress_stream
    from deflate_rs_tpu_torch.parallel import corpus
    from deflate_rs_tpu_torch.utils.mix import mix as mix_bytes

    bs = args.batch_size or corpus.BATCH_SIZE
    qd = args.queue_depth or corpus.QUEUE_DEPTH
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    mix = mix_bytes()
    default = dt.CompressionOptions.default()
    engines = {
        "corpus": lambda: corpus.compress_corpus(mix, batch_size=bs, queue_depth=qd,
                                                 device="cuda"),
        "chunk_batch": lambda: compress_stream(mix, default, pipelined=False, device="cuda",
                                               batch_chunks=bs),
    }
    print(json.dumps({"card": smi, "mix_bytes": len(mix), "batch_size": bs, "queue_depth": qd}))
    for name, run in engines.items():
        run()  # warm
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.events()
        # The program's ranges are host ranges only (runtime/trace.py): every
        # device event is device work.
        on_device = [e for e in events if e.device_type == DeviceType.CUDA]
        device = [(e.time_range.start, e.time_range.end) for e in on_device]
        if not device:
            print("corpus_profile: the profiler saw no device activity", file=sys.stderr)
            return 1
        busy = _busy_us(device) / 1e6
        # Copies and memsets apart: a copy that waits in its stream for an
        # event may be reported from the time it was queued.
        kernels = [(e.time_range.start, e.time_range.end) for e in on_device
                   if not e.name.startswith(("Memcpy", "Memset"))]
        longest = sorted(on_device, key=lambda e: -e.time_range.elapsed_us())[:3]
        ranges = {}
        for e in events:
            if e.device_type == DeviceType.CPU and e.name.startswith("corpus."):
                ranges[e.name] = ranges.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
        print(json.dumps({
            "engine": name, "unprofiled_wall_s": walls,
            "unprofiled_mb_per_s": [len(mix) / 1e6 / w for w in walls],
            "profiled_wall_s": wall, "device_activities": len(device),
            "device_busy_s": busy, "idle_share": 1 - busy / wall,
            "kernels": len(kernels), "kernels_busy_s": _busy_us(kernels) / 1e6,
            "kernels_sum_s": sum(hi - lo for lo, hi in kernels) / 1e6,
            "idle_share_kernels": 1 - _busy_us(kernels) / 1e6 / wall,
            "longest_activities_us": [[e.name[:60], e.time_range.elapsed_us()] for e in longest],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "host_range_s": ranges,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
