"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):

1. setup: a CUDA device is required (no CPU fallback); prints the card's
   name and power limit and builds the CUDA kernels from
   ``deflate_rs_tpu_torch/csrc``.
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, in both emit tiers (4 KiB and 64 KiB), on inputs harvested
   from the encoders' own runs over 32 chunks of the mix below: Default
   (every kernel; quarter histograms at nq = 8), fast (nq = 1), rle
   (nq = 4) and high (lr_measure at 32 segments).  Exact equality is
   required.  Prints kernel and plain times (CUDA events).
3. default: ``deflate_bytes``, ``deflate_bytes_zlib`` and
   ``deflate_bytes_gzip`` on a 16 MiB mix (pg11 text, structured records,
   random bytes, runs); each output must round-trip through stdlib
   zlib/gzip, pg11 must compress to 60,196 bytes, the CUDA bytes must equal
   the CPU port's on pg11 and the first 1 MiB of the mix, and every
   kernel's launch counter must have moved during the timed run.
4. presets: fast, high, rle, huffman_only, turbo, ForceFixed and
   ForceStored on pg11, CUDA bytes equal to the CPU port's and
   round-tripping; high and fast on the 16 MiB mix, timed warm, in all
   three framings, CUDA bytes equal to the CPU port's on its first 1 MiB;
   every kernel's launch counter must move during the timed high run.

The last two lines are a JSON object describing the kernels and the
``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
MIX_BYTES = 16 << 20
BATCH = 32


def build_mix(total_bytes: int, text: bytes):
    """pg11 text, structured records, random bytes and runs, seeded."""
    import numpy as np

    rng = np.random.default_rng(1234)
    rec = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    structured = b"".join(
        rec[:48] + int(i).to_bytes(8, "little") + rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
        for i in range(4096)
    )
    rand = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    runs = (b"\x00" * 4096 + b"\xff" * 2048 + b"ab" * 1024) * 64
    unit = text * 8 + structured * 2 + rand + runs
    return (unit * (total_bytes // len(unit) + 1))[:total_bytes]


def cuda_ms(fn, iters: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def harvest(encoder, bufs, hist, ns, last):
    """Run ``encoder`` once, recording the first inputs of each kernel wrapper."""
    from deflate_rs_tpu_torch.ops import chunk_encode, longrange, package_merge

    seen = {}
    patches = [(longrange, "lr_measure"), (chunk_encode, "parse_scan"),
               (chunk_encode, "token_fields"), (package_merge, "lengths_by_rank"),
               (chunk_encode, "quarter_histograms")]
    originals = [getattr(m, name) for m, name in patches]

    def recorder(name, fn):
        def wrapped(*args):
            key = name if name != "lengths_by_rank" else f"{name}_{args[1]}"
            seen.setdefault(key, args)
            return fn(*args)
        return wrapped

    for (m, name), fn in zip(patches, originals):
        setattr(m, name, recorder(name, fn))
    try:
        encoder(bufs, hist, ns, last)
    finally:
        for (m, name), fn in zip(patches, originals):
            setattr(m, name, fn)
    return seen


def timed_run(dt, cuda, data: bytes, opts, label: str, skip: tuple = ()) -> dict:
    """Warm run, then ``deflate_bytes_conf`` timed with the launch counters
    set to 0 just before it; zlib and gzip framings after.  All three must
    round-trip, and every kernel not in ``skip`` (kernels off the preset's
    path) must have launched.  Returns the launch counts of the timed run."""
    import torch

    dt.deflate_bytes_conf(data, opts, device="cuda")  # warm run
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    out_raw = dt.deflate_bytes_conf(data, opts, device="cuda")
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in cuda.KERNELS.items()}
    t0 = time.perf_counter()
    out_z = dt.deflate_bytes_zlib_conf(data, opts, device="cuda")
    wall_z = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_g = dt.deflate_bytes_gzip_conf(data, dt.GzBuilder(), opts, device="cuda")
    wall_g = time.perf_counter() - t0
    if zlib.decompress(out_raw, -15) != data:
        raise SystemExit(f"{label}: raw deflate stream does not round-trip")
    if zlib.decompress(out_z) != data:
        raise SystemExit(f"{label}: zlib stream does not round-trip")
    if gzip.decompress(out_g) != data:
        raise SystemExit(f"{label}: gzip stream does not round-trip")
    mb = len(data) / 1e6
    print(f"{label}: 16 MiB mix round-trips in raw/zlib/gzip; ratio "
          f"{len(out_raw) / len(data):.4f}; deflate {wall:.3f} s = {mb / wall:.2f} MB/s, "
          f"zlib {mb / wall_z:.2f} MB/s, gzip {mb / wall_g:.2f} MB/s "
          f"(warm, {BATCH} chunks per batch)")
    print(f"{label}: launches during the timed deflate run: {launches}")
    missing = [k for k, v in launches.items() if v == 0 and k not in skip]
    if missing:
        raise SystemExit(f"{label}: kernels not launched on its path: {missing}")
    return launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import deflate_rs_tpu_torch as dt
    from deflate_rs_tpu_torch.models.deflate import _chunk_buffers
    from deflate_rs_tpu_torch.ops import (field_kernel, hist_kernel, lr_kernel, parse_scan,
                                          pm_kernel)
    from deflate_rs_tpu_torch.ops.chunk_encode import ChunkEncoder
    from deflate_rs_tpu_torch.runtime import cuda

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # ------------------------------------------------------------- setup
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"setup: {smi}")
    t0 = time.perf_counter()
    cuda.load_library()
    print(f"setup: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {cuda.build_seconds if cuda.build_seconds is not None else 0:.1f} s), "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    with open(os.path.join(HERE, "tests", "data", "pg11.txt"), "rb") as f:
        pg11 = f.read()
    mix = build_mix(MIX_BYTES, pg11)
    O = dt.CompressionOptions
    presets = {
        "fast": O.fast(), "high": O.high(), "rle": O.rle(),
        "huffman_only": O.huffman_only(), "turbo": O.turbo(),
        "ForceFixed": O(special=dt.SpecialOptions.ForceFixed),
        "ForceStored": O(special=dt.SpecialOptions.ForceStored),
    }

    # ------------------------------------------ kernels vs plain, both tiers
    def quarter_hist_plain(a):
        return hist_kernel.quarter_histograms_plain(*a)

    def quarter_hist_kernel(a):
        return hist_kernel.quarter_histograms(*a)

    plain = {
        "lr_measure": lambda a: lr_kernel.lr_measure_plain(*a),
        "parse_scan": lambda a: parse_scan.parse_scan_plain(*a),
        "token_fields": lambda a: field_kernel.token_fields_plain(*a),
        "lengths_by_rank_15": lambda a: pm_kernel.lengths_by_rank_plain(*a),
        "lengths_by_rank_7": lambda a: pm_kernel.lengths_by_rank_plain(*a),
        "quarter_hist_nq8": quarter_hist_plain,
        "quarter_hist_nq1": quarter_hist_plain,
        "quarter_hist_nq4": quarter_hist_plain,
        "lr_measure_s32": lambda a: lr_kernel.lr_measure_plain(*a),
    }
    kern = {
        "lr_measure": lambda a: lr_kernel.lr_measure(*a),
        "parse_scan": lambda a: parse_scan.parse_scan(*a),
        "token_fields": lambda a: field_kernel.token_fields(*a),
        "lengths_by_rank_15": lambda a: pm_kernel.lengths_by_rank(*a),
        "lengths_by_rank_7": lambda a: pm_kernel.lengths_by_rank(*a),
        "quarter_hist_nq8": quarter_hist_kernel,
        "quarter_hist_nq1": quarter_hist_kernel,
        "quarter_hist_nq4": quarter_hist_kernel,
        "lr_measure_s32": lambda a: lr_kernel.lr_measure(*a),
    }
    # Which encoder's run supplies each kernel's inputs: (preset, recorded key).
    source = {
        "lr_measure": ("default", "lr_measure"),
        "parse_scan": ("default", "parse_scan"),
        "token_fields": ("default", "token_fields"),
        "lengths_by_rank_15": ("default", "lengths_by_rank_15"),
        "lengths_by_rank_7": ("default", "lengths_by_rank_7"),
        "quarter_hist_nq8": ("default", "quarter_histograms"),
        "quarter_hist_nq1": ("fast", "quarter_histograms"),
        "quarter_hist_nq4": ("rle", "quarter_histograms"),
        "lr_measure_s32": ("high", "lr_measure"),
    }
    harvest_opts = {"default": O.default(), "fast": O.fast(), "rle": O.rle(), "high": O.high()}
    results = {}
    for emit in (4096, 65536):
        if emit == 65536:
            offsets = [i * 65536 for i in range(BATCH)]
            bufs, hist, ns, last = _chunk_buffers(mix, offsets, emit)
        else:
            pieces = [mix[i * 4096 * 7 : i * 4096 * 7 + 4096] for i in range(BATCH)]
            bufs = np.stack([_chunk_buffers(p, [0], emit)[0][0] for p in pieces])
            hist, ns = np.zeros(BATCH, np.int64), np.full(BATCH, 4096, np.int64)
            last = np.ones(BATCH, bool)
        seen = {}
        for name, o in harvest_opts.items():
            enc = ChunkEncoder(o, emit).to(dev)
            with torch.no_grad():
                seen[name] = harvest(enc, torch.from_numpy(bufs).to(dev), torch.from_numpy(hist),
                                     torch.from_numpy(ns), torch.from_numpy(last))
        for key in plain:
            preset, rec = source[key]
            args = seen[preset][rec]
            got, want = kern[key](args), plain[key](args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                      for g, w in zip(got, want))
            shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
            k_ms = cuda_ms(lambda: kern[key](args))
            p_ms = cuda_ms(lambda: plain[key](args))
            print(f"kernel {key} ({preset}) emit={emit} shapes={shapes}: max_abs_err={err} "
                  f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms")
            if err != 0:
                raise SystemExit(f"kernel {key} disagrees with its plain version at emit={emit}")
            r = results.setdefault(key, {"max_abs_err": 0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if emit == 65536:
                r["ms"], r["plain_ms"] = k_ms, p_ms
    print(f"kernels: phase done at {time.perf_counter() - t_start:.1f} s")

    # ------------------------------------------------------ default path
    raw = dt.deflate_bytes(pg11, device="cuda")
    if len(raw) != 60196:
        raise SystemExit(f"pg11 compressed to {len(raw)} bytes, expected 60196")
    if raw != dt.deflate_bytes(pg11, device="cpu"):
        raise SystemExit("pg11: CUDA bytes differ from the CPU port's")
    head = mix[: 1 << 20]
    if dt.deflate_bytes(head, device="cuda") != dt.deflate_bytes(head, device="cpu"):
        raise SystemExit("mix[:1 MiB]: CUDA bytes differ from the CPU port's")
    print("default: pg11 -> 60196 B; CUDA bytes == CPU port bytes on pg11 and mix[:1 MiB]")
    timed_run(dt, cuda, mix, O.default(), "default")
    print(f"default: phase done at {time.perf_counter() - t_start:.1f} s")

    # ------------------------------------------------------- other presets
    for name, o in presets.items():
        got = dt.deflate_bytes_conf(pg11, o, device="cuda")
        if got != dt.deflate_bytes_conf(pg11, o, device="cpu"):
            raise SystemExit(f"{name}: CUDA bytes differ from the CPU port's on pg11")
        if zlib.decompress(got, -15) != pg11:
            raise SystemExit(f"{name}: pg11 stream does not round-trip")
        print(f"presets: {name} pg11 -> {len(got)} B, CUDA bytes == CPU port bytes, round-trips")
    launches = {}
    for name in ("fast", "high"):
        o = presets[name]
        if dt.deflate_bytes_conf(head, o, device="cuda") != dt.deflate_bytes_conf(head, o, device="cpu"):
            raise SystemExit(f"{name}: CUDA bytes differ from the CPU port's on mix[:1 MiB]")
        print(f"presets: {name} CUDA bytes == CPU port bytes on mix[:1 MiB]")
        # fast runs no long-range pass (the only preset with a matcher
        # that skips it), so lr_measure is off its path.
        launches[name] = timed_run(dt, cuda, mix, o, name,
                                   skip=("lr_measure",) if name == "fast" else ())
    print(f"presets: phase done at {time.perf_counter() - t_start:.1f} s")

    sources = {
        "lr_measure": ("deflate_rs_tpu_torch/csrc/lr_measure.cu", "deflate_rs_tpu/ops/lr_kernel.py:84",
                       ["lr_measure", "lr_measure_s32"], ["lr_measure"]),
        "parse_scan": ("deflate_rs_tpu_torch/csrc/parse_scan.cu", "deflate_rs_tpu/ops/parse_scan.py:44",
                       ["parse_scan"], ["parse_scan"]),
        "package_merge": ("deflate_rs_tpu_torch/csrc/package_merge.cu",
                          "deflate_rs_tpu/ops/pm_kernel.py:57",
                          ["lengths_by_rank_15", "lengths_by_rank_7"],
                          ["lengths_by_rank_15", "lengths_by_rank_7"]),
        "token_fields": ("deflate_rs_tpu_torch/csrc/token_fields.cu",
                         "deflate_rs_tpu/ops/field_kernel.py:33", ["token_fields"], ["token_fields"]),
        "quarter_hist": ("deflate_rs_tpu_torch/csrc/quarter_hist.cu",
                         "deflate_rs_tpu/ops/hist_kernel.py:35",
                         ["quarter_hist_nq8", "quarter_hist_nq1", "quarter_hist_nq4"],
                         ["quarter_hist_nq8"]),
    }
    rows = []
    for name, (src, rep, checked, timed) in sources.items():
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches["high"][name],
            "max_abs_err": max(results[k]["max_abs_err"] for k in checked),
            "ms": sum(results[k]["ms"] for k in timed),
            "plain_ms": sum(results[k]["plain_ms"] for k in timed),
        })
    print(f"done in {time.perf_counter() - t_start:.1f} s; kernels row: launches from the "
          "timed high run, ms / plain_ms at the 64 KiB tier on Default's inputs")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
