"""Per-stage timing of the chunk encoder on the card.

The torch form of ``scripts/stage_timing.py`` and
``scripts/downstream_timing.py``.  Those re-implement the stages; this tool
runs ``ChunkEncoder``'s own stage methods (``ChunkEncoder.STAGES``: lz77,
long_range, parse, symbols, histograms, scoring, tables, fields, pack,
checksums), each on the real outputs of the stages before it, computed
beforehand.  On the first ``--batch`` chunks of the 16 MiB mix
(``utils/mix.py``) it prints one JSON line per stage, then one for the whole
``forward``:

- ``wall_ms``: host clock, synchronised before and after, eager (median of
  ``--reps`` runs after a warm one);
- ``busy_ms``: the union of the device's kernel, copy and memset intervals
  under ``torch.profiler``, one window per stage: one trace holds every
  stage and the ``forward``, each between two marker kernels on the
  device's timeline (the forward's row gives ``traces``, the traces taken);
- ``kernels``: device kernels launched (copies and memsets apart);
- ``top``: the three kernels with the most device time, by name;
- ``card``: the card's name and power limit.

The encoder is the one-shot and corpus engines' (no checksum partials).  A
stage that does nothing at the configuration (``long_range`` without the
hash matcher's long-range pass, ``checksums``) prints ``"runs": false`` and
no numbers.  If the profiler sees no device
activity the tool fails; it prints no zeros.  ``--device cpu`` runs the same
chain on the CPU and prints only ``cpu_wall_ms``, the host's time, which is
no device metric.

    python3 -m deflate_rs_tpu_torch.tools.stage_timing [--preset default] [--batch 64] [--emit 65536]
    python3 -m deflate_rs_tpu_torch.tools.stage_timing --emit 4194304  # 16 chunks of 4 MiB
    python3 -m deflate_rs_tpu_torch.tools.stage_timing --preset fast --emit 16777216  # 4 of 16 MiB
    python3 -m deflate_rs_tpu_torch.tools.stage_timing --device cpu --batch 2 --emit 4096
"""

from __future__ import annotations

import argparse
import bisect
import functools
import json
import statistics
import subprocess
import sys
import time

import torch

from .corpus_profile import _busy_us

PRESETS = ("default", "fast", "high", "rle", "huffman_only", "turbo")


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def batch_inputs(data: bytes, batch: int, emit: int):
    """The encoder's inputs for the first ``batch`` chunks of ``emit`` bytes
    of ``data``, each with its 32 KiB of history; none is the stream's last."""
    from .dryrun_multichip import build_batch

    bufs, hist, ns, lasts = build_batch(data[: batch * emit], emit)
    lasts[:] = False
    return bufs, hist, ns, lasts


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _wall_ms(fn, device, reps: int) -> float:
    walls = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        walls.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(walls)


MARKER = "spin_kernel"  # the kernel of ``torch.cuda._sleep``: a window's edge


def _marker() -> None:
    torch.cuda._sleep(1 << 12)
    torch.cuda.synchronize()


def split_windows(events: list, n: int):
    """The ``n`` windows of device activity between ``n + 1`` marker kernels.

    ``events`` are (name, start, end) triples.  Activity before the first
    marker or after the last falls in no window.  None where the markers are
    not ``n + 1``: the trace then lost one, and its windows cannot be told
    apart."""
    marks = sorted(lo for name, lo, _ in events if MARKER in name)
    if len(marks) != n + 1:
        return None
    windows = [[] for _ in range(n)]
    for name, lo, hi in events:
        i = bisect.bisect_right(marks, lo) - 1
        if MARKER not in name and 0 <= i < n:
            windows[i].append((name, lo, hi))
    return windows


def window_row(window: list) -> dict:
    """``busy_ms``, ``kernels``, ``copies`` and ``top`` of one window."""
    kernels = [e for e in window if not e[0].startswith(("Memcpy", "Memset"))]
    by_name = {}
    for name, lo, hi in kernels:
        us, count = by_name.get(name, (0.0, 0))
        by_name[name] = (us + hi - lo, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:3]
    return {"busy_ms": _busy_us([(lo, hi) for _, lo, hi in window]) / 1e3,
            "kernels": len(kernels), "copies": len(window) - len(kernels),
            "top": [[name[:80], round(us / 1e3, 6), count] for name, (us, count) in top]}


def _profile(fns: list, attempts: int = 3) -> tuple:
    """(one ``window_row`` per call of ``fns``, the traces it took) under
    ``torch.profiler``.

    One trace holds every call, each in a window between two marker kernels,
    the device synchronised around it.  A trace may lose the device activity
    at its edges (a later profiler in one process was seen to lose a
    window's first kernels, and once all of a short one's), so the trace
    opens and closes with a call of ``fns[-1]`` outside every window.  A
    trace with a lost marker or an empty window is taken again, at most
    ``attempts`` times in all; then the tool fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fns[-1]()
            for fn in fns:
                _marker()
                fn()
                torch.cuda.synchronize()
            _marker()
            fns[-1]()
            torch.cuda.synchronize()
        # The profiler mirrors host ranges onto the device's timeline: no device work.
        events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        windows = split_windows(events, len(fns))
        if windows is not None and all(windows):
            return [window_row(w) for w in windows], attempt
    raise RuntimeError(f"stage_timing: the profiler saw no device activity in a window "
                       f"({attempts} traces; {len(events)} device activities in the last)")


def stage_rows(preset: str = "default", batch: int | None = None, emit: int = 65536, *,
               device="cuda", reps: int = 5, data: bytes | None = None,
               card: str | None = None) -> list:
    """One dict per stage of ``ChunkEncoder.forward``, then one for the whole
    ``forward`` (``"stage": "forward"``), as the module docstring says.
    ``emit`` is any chunk size the corpus engine takes at ``preset``
    (``corpus.check_chunk_size``, up to 16 MiB), and ``batch`` by default its
    batch at that size (``corpus.default_batch_size``)."""
    from ..compression_options import CompressionOptions
    from ..ops.chunk_encode import ChunkEncoder
    from ..parallel.corpus import check_chunk_size, chunk_options, default_batch_size
    from ..utils.mix import mix

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("stage_timing: no CUDA device (pass device='cpu' for the CPU)")
    opts = getattr(CompressionOptions, preset)()
    check_chunk_size(emit, opts)
    opts = chunk_options(opts, emit)
    batch = default_batch_size(emit) if batch is None else batch
    if data is None:
        data = mix(batch * emit)
    bufs, hist, ns, lasts = (torch.from_numpy(a) for a in batch_inputs(data, batch, emit))
    enc = ChunkEncoder(opts, emit).to(dev)
    head = {"preset": preset, "batch": batch, "emit": emit, "device": str(dev)}
    if on_card:
        head["card"] = card or card_name()
    with torch.no_grad():
        dbufs = bufs.to(dev)
        state = enc.inputs(dbufs, hist, ns, lasts)
        jobs = []
        for name in enc.STAGES:  # the warm run, keeping each stage's operands
            fn = functools.partial(getattr(enc, name), state)
            after = fn()
            jobs.append((name, fn, after is not state))
            state = after
        jobs.append(("forward", functools.partial(enc, dbufs, hist, ns, lasts), True))
        key = "wall_ms" if on_card else "cpu_wall_ms"
        rows = [{"stage": name, **head, "runs": active} for name, _, active in jobs]
        for row, (_, fn, active) in zip(rows, jobs):
            if active:
                row[key] = _wall_ms(fn, dev, reps)
        if on_card:
            traced, traces = _profile([fn for _, fn, active in jobs if active])
            for row, window in zip([r for r in rows if r["runs"]], traced):
                row.update(window)
            rows[-1]["traces"] = traces
    stages = [r for r in rows[:-1] if r["runs"]]
    rows[-1]["sum_of_stages"] = {key: sum(r[key] for r in stages)}
    if on_card:
        rows[-1]["sum_of_stages"].update(busy_ms=sum(r["busy_ms"] for r in stages),
                                         kernels=sum(r["kernels"] for r in stages))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="default", choices=PRESETS)
    ap.add_argument("--batch", type=int, default=None,
                    help="chunks (default: the corpus engine's batch at --emit, 64 up to 1 MiB)")
    ap.add_argument("--emit", type=int, default=65536, help="chunk size, up to 16 MiB")
    ap.add_argument("--reps", type=int, default=5, help="timed runs per stage (median)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("stage_timing: no CUDA device (pass --device cpu for the CPU)", file=sys.stderr)
        return 1
    for row in stage_rows(a.preset, a.batch, a.emit, device=a.device, reps=a.reps):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
