"""Per-stage timing of the chunk encoder on the card.

The torch form of ``scripts/stage_timing.py`` and
``scripts/downstream_timing.py``.  Those re-implement the stages; this tool
runs ``ChunkEncoder``'s own stage methods (``ChunkEncoder.STAGES``: lz77,
long_range, parse, symbols, histograms, scoring, tables, fields, pack,
checksums), each on the real outputs of the stages before it, computed
beforehand.  On the first ``--batch`` chunks of the 16 MiB mix
(``utils/mix.py``) it prints one JSON line per stage, then one for the whole
``forward``:

- ``wall_ms``: host clock, synchronised before and after, the stage alone
  on the real outputs of the stages before it, eager (median of ``--reps``
  runs after a warm one);
- from one ``forward`` traced by ``torch.profiler`` with the program's
  ranges on (``runtime/trace.py``), the device activity that the stage's
  range ``encoder.<stage>`` launched (``portbench/launches.py``: the
  activity's CUDA call, then that call's parents on the host):
  ``busy_ms``, the union of its kernel, copy and memset intervals;
  ``kernels`` and ``copies``; ``top``, the three kernels with the most
  device time, by name;
- from the same trace, ``host_ms``, the host's time in the range, and
  ``gap_ms``, the device's idle gaps whose midpoint finds the host inside
  it (the card waiting for the stage's launches), as ``portbench/trace.py``'s
  ``breakdown`` puts gaps down to host ranges;
- ``card``: the card's name and power limit.

The ``forward`` row gives the whole ``forward``'s ``wall_ms``, and the same
numbers for all the activity the traced call launched, read from a range of
its own (``FORWARD``) around it: its stages' work and its own outside them
(the inputs' upload, the outputs), so the stages' sums can be held to it.
The encoder is the one-shot and corpus engines' (no checksum partials).  A
stage that does nothing at the configuration (``long_range`` without the
hash matcher's long-range pass, ``checksums``) prints ``"runs": false`` and
no numbers.  If the profiler sees no device activity in a stage that runs,
the tool fails; it prints no zeros.  ``--device cpu`` runs the same chain
on the CPU and prints only ``cpu_wall_ms``, the host's time, which is no
device metric.  The card's mode reads ``portbench`` (``launches``,
``trace``): run it from the root of the checkout.

    python3 -m deflate_rs_tpu_torch.tools.stage_timing [--preset default] [--batch 64] [--emit 65536]
    python3 -m deflate_rs_tpu_torch.tools.stage_timing --emit 4194304  # 16 chunks of 4 MiB
    python3 -m deflate_rs_tpu_torch.tools.stage_timing --preset fast --emit 16777216  # 4 of 16 MiB
    python3 -m deflate_rs_tpu_torch.tools.stage_timing --device cpu --batch 2 --emit 4096
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from ..runtime.trace import SWITCH, span

PRESETS = ("default", "fast", "high", "rle", "huffman_only", "turbo")
# The range around the traced ``forward`` (``_traced_forward``).
FORWARD = "stage_timing.forward"


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


def window_row(window: list) -> dict:
    """``busy_ms``, ``kernels``, ``copies`` and ``top`` of a list of device
    activities ``[start_us, end_us, name]``."""
    from portbench.trace import busy_us, is_copy

    kernels = [a for a in window if not is_copy(a[2])]
    by_name = {}
    for lo, hi, name in kernels:
        us, count = by_name.get(name, (0.0, 0))
        by_name[name] = (us + hi - lo, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:3]
    return {"busy_ms": busy_us(window) / 1e3,
            "kernels": len(kernels), "copies": len(window) - len(kernels),
            "top": [[name[:80], round(us / 1e3, 6), count] for name, (us, count) in top]}


def stage_windows(events, stages) -> dict:
    """``window_row`` of the activity each ``encoder.<stage>`` range of
    ``events`` launched, with ``host_ms``, the host's time in the range, and
    ``gap_ms``, the device's idle gaps in which the host was inside it,
    built as ``portbench/trace.py``'s ``breakdown`` builds them; by stage,
    and under ``"forward"`` the same of the ``FORWARD`` range, its stages
    included."""
    from portbench.launches import OUTSIDE, host_ranges, launched_in
    from portbench.trace import breakdown

    prefixes = ("encoder.", FORWARD)
    launched, ranges = launched_in(events, prefixes), host_ranges(events, prefixes)
    device = [a for acts in launched.values() for a in acts]
    gaps = dict(breakdown({"device": device, "host_ranges": ranges},
                          top=len(ranges) + 1)["idle_gaps"])

    def row(key, acts, gap_s):
        return {**window_row(acts), "host_ms": sum(e - s for s, e in ranges.get(key, ())) / 1e3,
                "gap_ms": 1e3 * gap_s}

    rows = {name: row("encoder." + name, launched.get("encoder." + name, []),
                      gaps.get("encoder." + name, 0.0)) for name in stages}
    rows["forward"] = row(FORWARD, [a for k, acts in launched.items() if k != OUTSIDE
                                    for a in acts],
                          sum(s for k, s in gaps.items() if k != OUTSIDE))
    return rows


@contextlib.contextmanager
def _ranges_on():
    """The program's ranges on for the block (``runtime/trace.py``)."""
    was = os.environ.get(SWITCH)
    os.environ[SWITCH] = "1"
    try:
        yield
    finally:
        if was is None:
            del os.environ[SWITCH]
        else:
            os.environ[SWITCH] = was


def _traced_forward(forward) -> list:
    """The events of one ``torch.profiler`` trace of ``forward`` with the
    program's ranges on, inside the range ``FORWARD``, between two calls
    with them off: a trace may lose the device activity at its edges (a
    later profiler in one process was seen to lose a window's first
    kernels), and those calls' activity falls under no range."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
        with _ranges_on(), span(FORWARD):
            forward()
        torch.cuda.synchronize()
        forward()
        torch.cuda.synchronize()
    return prof.events()


def stage_rows(preset: str = "default", batch: int | None = None, emit: int = 65536, *,
               device="cuda", reps: int = 5, data: bytes | None = None,
               card: str | None = None) -> list:
    """One dict per stage of ``ChunkEncoder.forward``, then one for the whole
    ``forward`` (``"stage": "forward"``), as the module docstring says.
    ``emit`` is any chunk size the corpus engine takes at ``preset``
    (``corpus.check_chunk_size``, up to 32 MiB), and ``batch`` by default its
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
            windows = stage_windows(_traced_forward(jobs[-1][1]), enc.STAGES)
            for row in rows:
                if row["runs"]:
                    row.update(windows[row["stage"]])
            lost = [r["stage"] for r in rows if r["runs"] and not r["kernels"] + r["copies"]]
            if lost:
                raise RuntimeError(f"stage_timing: the profiler saw no device activity in {lost}")
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
    ap.add_argument("--emit", type=int, default=65536, help="chunk size, up to 32 MiB")
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
