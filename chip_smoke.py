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
   (nq = 4) and high (lr_measure at 32 segments, package-merge at its
   2,304 rows).  Exact equality is required.  ``lr_measure`` and the
   quarter histograms are also checked and timed on one chunk alone
   (B = 1).  Then the adversarial operands of
   ``deflate_rs_tpu_torch/utils/kernel_cases.py`` go through ``parse_scan``,
   ``package_merge``, ``lr_measure`` and ``quarter_hist`` and their plain
   versions, exact equality again.  Prints per kernel: its time (CUDA events around replays
   of a CUDA graph of 20 calls of the wrapper, so the card's time without
   the host's launch cost; the eager loop's time beside it), the plain
   version's time, the bound computed from the operands just timed, and for
   the quarter histograms the time of one ``torch.bincount`` over
   precomputed offsets (a yardstick the port never calls).
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

The bound of a kernel is the larger of two times: its operands' bytes (each
input read once, each output written once) over 3.35 TB/s, and its integer
operations over 16.75 T op/s (the card's 67 TFLOP/s of float32 counts an FMA
as two on 128 lanes per SM; int32 has 64 lanes and counts one).  Operations
counted, from the data of the run: parse_scan 2 per token of the result;
package_merge 3 per live leaf and level (a merge of about 2m entries and m
pair sums); lr_measure 8 per word and live dominant; token_fields 10 and
quarter_hist 2 per position.

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_OPS_PER_S = 67e12 / 4  # see the module docstring


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


def kernel_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Per-call ms of a kernel wrapper on the card alone: CUDA events around
    replays of a CUDA graph that holds ``reps`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, replays) / reps


def bound_of(key: str, args, outs) -> tuple:
    """(bytes_ms, operations_ms) of one call: see the module docstring."""
    import torch

    from deflate_rs_tpu_torch.ops.pm_kernel import BIG

    nbytes = sum(t.numel() * t.element_size()
                 for t in (*args, *outs) if torch.is_tensor(t))
    if key.startswith("parse_scan"):
        ops = 2 * int(outs[0].sum())
    elif key.startswith("lengths_by_rank"):
        leaf, max_len = args
        ops = 3 * (max_len - 1) * int((leaf < BIG).sum())
    elif key.startswith("lr_measure"):
        ops = 8 * int((args[1] > 0).sum()) * outs[0].shape[-1]
    elif key.startswith("token_fields"):
        ops = 10 * args[1].numel()
    elif key.startswith("quarter_hist"):
        ops = 2 * args[0].numel()
    else:
        raise KeyError(key)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3


def bincount_yardstick(args, outs):
    """One ``torch.bincount`` that computes the quarter histograms from flat
    offsets made beforehand; returns (ms, agrees with ``outs``)."""
    import torch

    lsym, dcode, nq = args
    B, E = lsym.shape
    nl, nd = outs[0].shape[-1], outs[1].shape[-1]
    q = torch.arange(E, device=lsym.device) // (E // nq)
    b = torch.arange(B, device=lsym.device)[:, None]
    trash = B * nq * (nl + nd)
    off_l = torch.where((lsym >= 0) & (lsym < nl), (b * nq + q) * nl + lsym, trash)
    off_d = torch.where((dcode >= 0) & (dcode < nd), B * nq * nl + (b * nq + q) * nd + dcode, trash)
    flat = torch.cat([off_l.reshape(-1), off_d.reshape(-1)])
    counts = torch.bincount(flat, minlength=trash + 1)
    same = (torch.equal(counts[: B * nq * nl].view(B, nq, nl), outs[0].long())
            and torch.equal(counts[B * nq * nl : trash].view(B, nq, nd), outs[1].long()))
    return cuda_ms(lambda: torch.bincount(flat, minlength=trash + 1), 20), same


def tier_buffers(mix: bytes, emit: int):
    """The encoder's operands for one batch of the mix in the emit tier:
    the first 32 chunks of 64 KiB with their history, or 32 pieces of 4 KiB
    (each a stream of its own) for the small tier."""
    import numpy as np

    from deflate_rs_tpu_torch.models.deflate import _chunk_buffers

    if emit == 65536:
        return _chunk_buffers(mix, [i * 65536 for i in range(BATCH)], emit)
    pieces = [mix[i * 4096 * 7 : i * 4096 * 7 + 4096] for i in range(BATCH)]
    bufs = np.stack([_chunk_buffers(p, [0], emit)[0][0] for p in pieces])
    return (bufs, np.zeros(BATCH, np.int64), np.full(BATCH, 4096, np.int64),
            np.ones(BATCH, bool))


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
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import deflate_rs_tpu_torch as dt
    from deflate_rs_tpu_torch.ops import (field_kernel, hist_kernel, lr_kernel, parse_scan,
                                          pm_kernel)
    from deflate_rs_tpu_torch.ops.chunk_encode import ChunkEncoder
    from deflate_rs_tpu_torch.runtime import cuda
    from deflate_rs_tpu_torch.utils import kernel_cases

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
        "lengths_by_rank_15_high": lambda a: pm_kernel.lengths_by_rank_plain(*a),
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
        "lengths_by_rank_15_high": lambda a: pm_kernel.lengths_by_rank(*a),
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
        "lengths_by_rank_15_high": ("high", "lengths_by_rank_15"),
    }
    harvest_opts = {"default": O.default(), "fast": O.fast(), "rle": O.rle(), "high": O.high()}
    results = {}
    for emit in (4096, 65536):
        bufs, hist, ns, last = tier_buffers(mix, emit)
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
            k_ms = kernel_ms(lambda: kern[key](args))
            e_ms = cuda_ms(lambda: kern[key](args), 50)
            p_ms = cuda_ms(lambda: plain[key](args))
            bytes_ms, ops_ms = bound_of(key, args, got)
            lib_ms = None
            if key.startswith("quarter_hist"):
                lib_ms, same = bincount_yardstick(args, got)
                if not same:
                    raise SystemExit(f"{key}: the bincount yardstick computes another function")
            print(f"kernel {key} ({preset}) emit={emit} shapes={shapes}: max_abs_err={err} "
                  f"kernel {k_ms:.4f} ms (eager loop {e_ms:.4f}) plain {p_ms:.4f} ms "
                  f"bound {max(bytes_ms, ops_ms):.5f} ms (bytes {bytes_ms:.5f}, operations "
                  f"{ops_ms:.5f})" + (f" bincount {lib_ms:.4f} ms" if lib_ms is not None else ""))
            if err != 0:
                raise SystemExit(f"kernel {key} disagrees with its plain version at emit={emit}")
            r = results.setdefault(key, {"max_abs_err": 0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if emit == 65536:
                r.update(ms=k_ms, eager_ms=e_ms, plain_ms=p_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
                         library_ms=lib_ms)
            if emit == 65536 and key in ("lr_measure", "quarter_hist_nq8", "quarter_hist_nq1"):
                # One chunk alone: the shape a streaming encoder would launch.
                one = tuple(a[:1].contiguous() if torch.is_tensor(a) else a for a in args)
                got1, want1 = kern[key](one), plain[key](one)
                if not all(torch.equal(g, w) for g, w in zip(got1, want1)):
                    raise SystemExit(f"kernel {key} disagrees with its plain version at B=1")
                b1, o1 = bound_of(key, one, got1)
                print(f"kernel {key} ({preset}) emit={emit} B=1: max_abs_err=0 kernel "
                      f"{kernel_ms(lambda: kern[key](one)):.4f} ms (eager loop "
                      f"{cuda_ms(lambda: kern[key](one), 50):.4f}) bound {max(b1, o1):.5f} ms")

    # Adversarial operands: exact equality with the plain versions.
    for E, B, seed in kernel_cases.PARSE_CASES:
        steps, n = kernel_cases.parse_scan_batch(E, B, seed)
        st, nn = torch.from_numpy(steps).to(dev), torch.from_numpy(n).to(dev)
        if not torch.equal(parse_scan.parse_scan(st, nn), parse_scan.parse_scan_plain(st, nn)):
            raise SystemExit(f"parse_scan disagrees on the adversarial case E={E} B={B} seed={seed}")
    pm_cases = kernel_cases.package_merge_cases()
    for name, freqs, max_len in pm_cases:
        leaf = torch.from_numpy(kernel_cases.sorted_leaves(freqs)).to(dev)
        got = pm_kernel.lengths_by_rank(leaf, max_len)
        if got.shape != leaf.shape or (leaf.numel() and not torch.equal(
                got, pm_kernel.lengths_by_rank_plain(leaf, max_len))):
            raise SystemExit(f"package_merge disagrees on the adversarial case {name}")
    for B, S, N, seed in kernel_cases.LR_CASES:
        a = tuple(torch.from_numpy(x).to(dev) for x in kernel_cases.lr_measure_batch(B, S, N, seed))
        if not all(torch.equal(g, w) for g, w in zip(lr_kernel.lr_measure(*a, N),
                                                     lr_kernel.lr_measure_plain(*a, N))):
            raise SystemExit(f"lr_measure disagrees on the adversarial case B={B} S={S} N={N} "
                             f"seed={seed}")
    for B, E, nq, seed in kernel_cases.HIST_CASES:
        a = tuple(torch.from_numpy(x).to(dev) for x in kernel_cases.hist_batch(B, E, seed))
        if not all(torch.equal(g, w) for g, w in zip(
                hist_kernel.quarter_histograms(*a, nq),
                hist_kernel.quarter_histograms_plain(*a, nq))):
            raise SystemExit(f"quarter_hist disagrees on the adversarial case B={B} E={E} "
                             f"nq={nq} seed={seed}")
    torch.cuda.synchronize()
    print(f"kernels: adversarial cases equal the plain versions exactly: parse_scan "
          f"{len(kernel_cases.PARSE_CASES)}, package_merge {len(pm_cases)}, lr_measure "
          f"{len(kernel_cases.LR_CASES)}, quarter_hist {len(kernel_cases.HIST_CASES)}")
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
    launches = {"default": timed_run(dt, cuda, mix, O.default(), "default")}
    print(f"default: phase done at {time.perf_counter() - t_start:.1f} s")

    # ------------------------------------------------------- other presets
    for name, o in presets.items():
        got = dt.deflate_bytes_conf(pg11, o, device="cuda")
        if got != dt.deflate_bytes_conf(pg11, o, device="cpu"):
            raise SystemExit(f"{name}: CUDA bytes differ from the CPU port's on pg11")
        if zlib.decompress(got, -15) != pg11:
            raise SystemExit(f"{name}: pg11 stream does not round-trip")
        print(f"presets: {name} pg11 -> {len(got)} B, CUDA bytes == CPU port bytes, round-trips")
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
                          ["lengths_by_rank_15", "lengths_by_rank_7", "lengths_by_rank_15_high"],
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
        # A batch of Default calls every key of ``timed`` once: the sums are
        # the kernel's cost per batch of 32 chunks.
        bytes_ms = sum(results[k]["bytes_ms"] for k in timed)
        ops_ms = sum(results[k]["ops_ms"] for k in timed)
        lib = [results[k]["library_ms"] for k in timed]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches["default"][name],
            "launches_default": launches["default"][name],
            "launches_high": launches["high"][name],
            "max_abs_err": max(results[k]["max_abs_err"] for k in checked),
            "ms": sum(results[k]["ms"] for k in timed),
            "eager_ms": sum(results[k]["eager_ms"] for k in timed),
            "plain_ms": sum(results[k]["plain_ms"] for k in timed),
            "bound_ms": sum(max(results[k]["bytes_ms"], results[k]["ops_ms"]) for k in timed),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None if None in lib else sum(lib),
        })
    high_pm = results["lengths_by_rank_15_high"]
    print(f"package_merge at high's shape: kernel {high_pm['ms']:.4f} ms plain "
          f"{high_pm['plain_ms']:.4f} ms bound {max(high_pm['bytes_ms'], high_pm['ops_ms']):.5f} ms")
    print(f"done in {time.perf_counter() - t_start:.1f} s; kernels row: launches of the timed "
          "Default run (the main path) and of the timed high run, 8 batches of 32 chunks each; "
          "ms (CUDA-graph replay), eager_ms, plain_ms, bound_ms at the 64 KiB tier on "
          "Default's inputs")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
