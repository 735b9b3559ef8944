"""A/B timing of two versions of the redesigned CUDA kernels.

Times from different runs on different cards differ by more than these
kernels' gaps, so the old and the new sources are built into two libraries
and timed in one process on the same operands, in turns (old, new, new,
old).  Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m deflate_rs_tpu_torch.tools.kernel_ab --old-csrc DIR [DIR ...] \\
        [--kernels lr_measure,lr_measure_tiled,token_fields,quarter_hist,parse_scan,package_merge] \\
        [--iters 200] [--sass]

``DIR`` holds the older source of every kernel named (for example
``git show <commit>:deflate_rs_tpu_torch/csrc/lr_measure.cu``;
``lr_measure_tiled``, the tiled path, lives in ``lr_measure.cu`` too); the
new ones are the package's own.  Several directories (steps of a redesign)
are timed in the order given, then the new sources, then all again in
reverse.  Operands:

- ``lr_measure``: the Default encoder's inputs at 32 and 64 chunks of 64 KiB
  (64 segments; 64 chunks is the corpus engine's batch), the ``high``
  encoder's (32 segments), Default's in the 4 KiB tier, one chunk alone, and
  two adversarial batches (every pattern mixed; all-zero buffers, where every
  live dominant ties over the whole window), all on the block path;
- ``lr_measure_tiled``: what the ``lr_global`` pass hands it (one segment,
  D slots): Default at D = 64 on 64 chunks, one chunk, D = 256, high, 32
  streams of 4 KiB and 8 chunks of 256 KiB, and the all-zero batch at D = 64;
- ``token_fields``: Default's inputs at 64 chunks, one chunk, 32 streams of
  4 KiB, 8 chunks of 256 KiB and the sharded step's 256 chunks, and the 64
  chunks again one element into their buffers (rows not 16-byte aligned);
- ``quarter_hist``: Default's (nq 8), fast's (nq 1) and rle's (nq 4)
  inputs, one chunk alone at nq 8 and nq 1, and one symbol at every
  position at nq 1 and nq 8;
- ``parse_scan``: Default's inputs and three adversarial patterns;
- ``package_merge``: Default's two calls, high's 2,304 x 286 rows and two
  adversarial batches.

The harvested inputs are recorded as ``chip_smoke.py`` does; the adversarial
ones come from ``utils/kernel_cases.py``.  Both versions must equal the plain
twin on every set.

Two clocks per entry, both CUDA events: ``eager`` is a loop of ``--iters``
raw launches from Python (host launch cost included where the kernel is
shorter than it), ``graph`` replays a CUDA graph of the same launches (the
card's time alone).  It prints one JSON object per line, with each entry's
bound (``bound_ms``, as ``chip_smoke.py`` computes it) beside its times.
``--sass`` also prints, per version and kernel function, the counts of the
shared-memory, atomic and load instructions in its SASS (``cuobjdump``),
and ``ptxas`` reports each function's registers and spills.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

KERNELS = ("lr_measure", "lr_measure_tiled", "token_fields", "quarter_hist", "parse_scan",
           "package_merge")
SOURCE = {k: "lr_measure.cu" if k == "lr_measure_tiled" else f"{k}.cu" for k in KERNELS}
# SASS opcodes counted by --sass (by prefix, predicates and modifiers kept).
SASS_OPS = ("ATOMS", "ATOMG", "ATOM", "RED", "LDS", "STS", "LDG", "STG", "SHFL", "VOTE")


def _build(nvcc: str, flags: list, sources: list, out: str) -> ctypes.CDLL:
    proc = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-o", out, *sources],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {sources}:\n{proc.stdout}\n{proc.stderr}")
    for line in proc.stderr.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    return ctypes.CDLL(out)


def _sass(nvcc: str, flags: list, source: str, out: str) -> dict:
    """{kernel function: {opcode: count}} of ``source``'s SASS, for the
    opcodes of ``SASS_OPS`` (counted with their modifiers, e.g. LDS.128)."""
    cubin_flags = [f for f in flags if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([nvcc, *cubin_flags, "-cubin", "-o", out, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc -cubin failed on {source}:\n{proc.stderr}")
    dump = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", out],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in dump.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = {}
        elif fn and line.startswith("/*") and "*/" in line:
            words = line.split("*/", 1)[1].replace(";", " ").split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words and words[0].split(".")[0] in SASS_OPS:
                counts[fn][words[0]] = counts[fn].get(words[0], 0) + 1
    return counts


def _times(torch, launch, iters: int) -> dict:
    """Per-launch ms of ``launch()``: an eager loop and a CUDA-graph replay."""
    def events(fn, count):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / count

    def loop():
        for _ in range(iters):
            launch()

    loop()
    eager = events(loop, iters)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loop()
    graph.replay()
    return {"eager_ms": eager, "graph_ms": events(graph.replay, iters)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", required=True, nargs="+", metavar="DIR")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ", ".join(KERNELS))
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--sass", action="store_true",
                    help="print the SASS instruction counts of every version's kernels")
    args = ap.parse_args()
    chosen = args.kernels.split(",")
    if not chosen or any(k not in KERNELS for k in chosen):
        ap.error(f"--kernels takes names of {KERNELS}")

    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke
    import deflate_rs_tpu_torch as dt
    from deflate_rs_tpu_torch.ops import hist_kernel, lr_kernel
    from deflate_rs_tpu_torch.ops import parse_scan as ps
    from deflate_rs_tpu_torch.ops import pm_kernel as pm
    from deflate_rs_tpu_torch.ops.chunk_encode import ChunkEncoder
    from deflate_rs_tpu_torch.runtime import cuda
    from deflate_rs_tpu_torch.utils import kernel_cases
    from deflate_rs_tpu_torch.utils.mix import mix as mix_bytes

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "iters": args.iters, "kernels": chosen}))
    names = sorted({SOURCE[k] for k in chosen})
    tmp = os.path.join(cuda.BUILD_DIR, "kernel_ab")
    os.makedirs(tmp, exist_ok=True)
    # Versions by name: "old" (or "old:DIR" where several were given), "new".
    dirs = {("old" if len(args.old_csrc) == 1 else f"old:{d}"): d for d in args.old_csrc}
    dirs["new"] = cuda.CSRC_DIR
    libs = {
        version: _build(cuda._nvcc(), cuda.NVCC_FLAGS, [os.path.join(d, n) for n in names],
                        os.path.join(tmp, f"lib{i}.so"))
        for i, (version, d) in enumerate(dirs.items())
    }
    if args.sass:
        for i, (version, d) in enumerate(dirs.items()):
            for n in names:
                for fn, counts in _sass(cuda._nvcc(), cuda.NVCC_FLAGS, os.path.join(d, n),
                                        os.path.join(tmp, f"{i}_{n}.cubin")).items():
                    print(json.dumps({"sass": version, "source": n, "function": fn,
                                      "counts": counts}))
    P, I = ctypes.c_void_p, ctypes.c_int
    argtypes = {
        "lr_measure": [P, I, P, I, I, I, I, I, P, P, P, P],
        "lr_measure_tiled": [P, I, P, I, I, I, I, I, P, P, P, P, P],
        "token_fields": [P] * 9 + [I, I, I] + [P] * 5,
        "quarter_hist": [P, P, I, I, I, P, P, P],
        "parse_scan": [P, P, I, I, P, P],
        "package_merge": [P, I, I, I, P, P],
    }
    for lib in libs.values():
        for k in chosen:
            getattr(lib, k).argtypes = argtypes[k]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    unequal = []

    def ab(kernel: str, operands: str, info: dict, call, outs, want, bound=None) -> None:
        """Time ``call(lib_fn)`` old, new, new, old; ``outs`` (overwritten
        before each turn's first launch) must equal ``want``.  ``bound``:
        (key, args) of ``chip_smoke.bound_of`` for the entry's bound."""
        if bound is not None:
            info = {**info, "bound_ms": max(chip_smoke.bound_of(*bound, want))}
        for which in [*libs, *reversed(libs)]:
            fn = getattr(libs[which], kernel)

            def run():
                err = call(fn)
                if err != 0:
                    raise SystemExit(f"{which} {kernel}: launch error {err}")

            for o in outs:
                o.fill_(-7)
            run()
            torch.cuda.synchronize()
            row = {"kernel": kernel, "operands": operands, **info, "version": which,
                   "equal": all(torch.equal(o, w) for o, w in zip(outs, want))}
            row.update(_times(torch, run, args.iters))
            print(json.dumps(row), flush=True)
            if not row["equal"]:
                unequal.append(row)

    # ----------------------------------------------------------- operands
    mix = mix_bytes()
    O = dt.CompressionOptions
    wanted = {"default": O.default(), "high": O.high()}
    if "quarter_hist" in chosen:
        wanted.update(fast=O.fast(), rle=O.rle())
    seen = {}
    for emit in (65536, 4096) if {"lr_measure", "token_fields"} & set(chosen) else (65536,):
        bufs, hist, ns, last = chip_smoke.tier_buffers(mix, emit)
        for name, o in wanted.items():
            if emit == 4096 and name != "default":
                continue
            with torch.no_grad():
                seen[name, emit] = chip_smoke.harvest(
                    ChunkEncoder(o, emit).to(dev), torch.from_numpy(bufs).to(dev),
                    torch.from_numpy(hist), torch.from_numpy(ns), torch.from_numpy(last))

    if {"lr_measure", "token_fields"} & set(chosen):  # and the corpus engine's batch, 64 chunks
        bufs, hist, ns, last = chip_smoke.tier_buffers(mix, 65536, 64)
        with torch.no_grad():
            seen["default", "b64"] = chip_smoke.harvest(
                ChunkEncoder(wanted["default"], 65536).to(dev), torch.from_numpy(bufs).to(dev),
                torch.from_numpy(hist), torch.from_numpy(ns), torch.from_numpy(last))

    def to_dev(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)

    # --------------------------------------------------------- lr_measure
    if "lr_measure" in chosen:
        lr_ops = {
            "default_s64": seen["default", 65536]["lr_measure"],
            "default_s64_b64": seen["default", "b64"]["lr_measure"],
            "high_s32": seen["high", 65536]["lr_measure"],
            "default_4k_tier": seen["default", 4096]["lr_measure"],
        }
        buf, doms, N = lr_ops["default_s64"]
        lr_ops["default_s64_one_chunk"] = (buf[:1].contiguous(), doms[:1].contiguous(), N)
        lr_ops["adversarial_mixed"] = (*to_dev(*kernel_cases.lr_measure_batch(32, 64, 98304, 0)),
                                       98304)
        rng = np.random.default_rng(5)
        rows = [kernel_cases.lr_operands("zeros", rng, 98304, 64) for _ in range(32)]
        lr_ops["adversarial_zeros"] = (*to_dev(np.stack([r[0] for r in rows]),
                                               np.stack([r[1] for r in rows])), 98304)
        for name, (buf, doms, N) in lr_ops.items():
            B, S, M = doms.shape
            LW = lr_kernel.window_words(N, S)
            want = lr_kernel.lr_measure_plain(buf, doms, N)
            outs = [torch.empty((B, S, LW), dtype=t, device=dev)
                    for t in (torch.int32, torch.int32, torch.int64)]

            def call(fn):
                return fn(buf.data_ptr(), buf.shape[1], doms.data_ptr(), B, S, M, N // S, LW,
                          outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(), stream())

            ab("lr_measure", name, {"shape": [B, S, M], "N": N,
                                    "live": float((doms > 0).float().mean())}, call, outs, want)

    # --------------------------------------------------- lr_measure, tiled
    if "lr_measure_tiled" in chosen:
        t64 = chip_smoke.tier_buffers(mix, 65536, 64)
        tiled_ops = {
            name: chip_smoke.global_operands(*spec) for name, spec in {
                "default_d64_b64": ("default", 64, t64, 65536, 0, 64),
                "default_d64_one_chunk": ("default", 64, t64, 65536, 1, 2),
                "default_d256_b64": ("default", 256, t64, 65536, 0, 64),
                "high_d64_b64": ("high", 64, t64, 65536, 0, 64),
                "default_d64_4k_tier": ("default", 64, chip_smoke.tier_buffers(mix, 4096), 4096,
                                        0, chip_smoke.BATCH),
                "default_d64_8x256k": ("default", 64, chip_smoke.wide_buffers(mix),
                                       chip_smoke.WIDE_EMIT, 0, chip_smoke.WIDE_BATCH),
            }.items()
        }
        rng = np.random.default_rng(8)
        rows = [kernel_cases.lr_global_operands("zeros", rng, 98304, 64) for _ in range(16)]
        tiled_ops["zeros_d64_b16"] = (*to_dev(np.stack([r[0] for r in rows]),
                                            np.stack([r[1] for r in rows])), 98304)
        for name, (buf, doms, N) in tiled_ops.items():
            B, S, M = doms.shape
            LW = lr_kernel.window_words(N, S)
            parts = [lr_kernel.lr_measure_plain(buf[i : i + 16], doms[i : i + 16], N)
                     for i in range(0, B, 16)]
            want = tuple(torch.cat(p) for p in zip(*parts))
            outs = [torch.empty((B, S, LW), dtype=t, device=dev)
                    for t in (torch.int32, torch.int32, torch.int64)]
            scratch = torch.empty(lr_kernel.tiled_scratch_words(B, S, M, LW), dtype=torch.int32,
                                  device=dev)

            def call(fn):
                return fn(buf.data_ptr(), buf.shape[1], doms.data_ptr(), B, S, M, N // S, LW,
                          scratch.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
                          outs[2].data_ptr(), stream())

            ab("lr_measure_tiled", name, {"shape": [B, S, M], "N": N,
                                          "live": int((doms > 0).sum())},
               call, outs, want, bound=("lr_measure", (buf, doms, N)))
        del tiled_ops
        torch.cuda.empty_cache()

    # ------------------------------------------------------- token_fields
    if "token_fields" in chosen:
        from deflate_rs_tpu_torch.ops import field_kernel
        from deflate_rs_tpu_torch.tools.dryrun_multichip import build_batch

        wide_opts = dataclasses.replace(O.default(), chain_scale=chip_smoke.WIDE_EMIT // 65536)
        step_kw = {"with_checksums": True, "stored_payload_fields": False}

        def fields_of(encoder, operands):
            bufs, hist, ns, last = (torch.from_numpy(a) for a in operands)
            with torch.no_grad():
                return chip_smoke.harvest(encoder.to(dev), bufs.to(dev), hist, ns,
                                          last)["token_fields"]

        b64 = seen["default", "b64"]["token_fields"]
        field_ops = {
            "default_b64": b64,
            "default_one_chunk": tuple(a[1:2].contiguous() for a in b64),
            "default_4k_tier_b32": seen["default", 4096]["token_fields"],
            "default_8x256k": fields_of(ChunkEncoder(wide_opts, chip_smoke.WIDE_EMIT),
                                        chip_smoke.wide_buffers(mix)),
            "sharded_step": fields_of(ChunkEncoder(O.default(), 65536, **step_kw),
                                      build_batch(mix, 65536)),
            "default_b64_unaligned": tuple(chip_smoke.unaligned(a) if a.dim() == 2 else a
                                           for a in b64),
        }
        for name, fargs in field_ops.items():
            B, E = fargs[1].shape
            nq = fargs[7].shape[1]
            want = field_kernel.token_fields_plain(*fargs)
            outs = [torch.empty((B, E), dtype=torch.int32, device=dev) for _ in range(4)]

            def call(fn):
                return fn(*(a.data_ptr() for a in fargs), B, E, nq,
                          *(o.data_ptr() for o in outs), stream())

            ab("token_fields", name, {"shape": [B, E], "nq": nq,
                                      "aligned": fargs[1].data_ptr() % 16 == 0},
               call, outs, want, bound=("token_fields", fargs))
        del field_ops
        torch.cuda.empty_cache()

    # ------------------------------------------------------- quarter_hist
    if "quarter_hist" in chosen:
        hist_ops = {
            "default_nq8": seen["default", 65536]["quarter_histograms"],
            "fast_nq1": seen["fast", 65536]["quarter_histograms"],
            "rle_nq4": seen["rle", 65536]["quarter_histograms"],
        }
        for name in ("default_nq8", "fast_nq1"):
            lsym, dcode, nq = hist_ops[name]
            hist_ops[f"{name}_one_chunk"] = (lsym[:1].contiguous(), dcode[:1].contiguous(), nq)
        rng = np.random.default_rng(6)
        one = to_dev(*(np.stack(x) for x in zip(
            *[kernel_cases.hist_operands("one_symbol", rng, 65536) for _ in range(32)])))
        hist_ops["one_symbol_nq1"] = (*one, 1)
        hist_ops["one_symbol_nq8"] = (*one, 8)
        for name, (lsym, dcode, nq) in hist_ops.items():
            B, E = lsym.shape
            want = hist_kernel.quarter_histograms_plain(lsym, dcode, nq)
            flat = torch.empty(B * nq * 316, dtype=torch.int32, device=dev)
            outs = [flat[: B * nq * 286].view(B, nq, 286), flat[B * nq * 286 :].view(B, nq, 30)]

            def call(fn):
                return fn(lsym.data_ptr(), dcode.data_ptr(), B, E, nq, outs[0].data_ptr(),
                          outs[1].data_ptr(), stream())

            ab("quarter_hist", name, {"shape": [B, E], "nq": nq}, call, outs, want)

    # --------------------------------------------------------- parse_scan
    if "parse_scan" in chosen:
        parse_ops = {"default": seen["default", 65536]["parse_scan"]}
        for pattern in ("max", "never_converge", "uniform"):
            rng = np.random.default_rng(7)
            steps = np.stack([kernel_cases.parse_steps(pattern, rng, 65536) for _ in range(32)])
            parse_ops[pattern] = (*to_dev(steps),
                                  torch.full((32,), 65536, dtype=torch.int32, device=dev))
        for name, (steps, n) in parse_ops.items():
            B, E = steps.shape
            out = torch.empty((B, E), dtype=torch.bool, device=dev)

            def call(fn):
                return fn(steps.data_ptr(), n.data_ptr(), B, E, out.data_ptr(), stream())

            ab("parse_scan", name, {"shape": [B, E]}, call, [out], [ps.parse_scan_plain(steps, n)])

    # ------------------------------------------------------ package_merge
    if "package_merge" in chosen:
        pm_ops = {
            "default_512x286_at_15": seen["default", 65536]["lengths_by_rank_15"],
            "default_256x19_at_7": seen["default", 65536]["lengths_by_rank_7"],
            "high_2304x286_at_15": seen["high", 65536]["lengths_by_rank_15"],
        }
        for name, freqs, max_len in kernel_cases.package_merge_cases():
            if name in ("mixed_2304x286", "m_sweep_286"):
                pm_ops[name] = (*to_dev(kernel_cases.sorted_leaves(freqs)), max_len)
        for name, (leaf, max_len) in pm_ops.items():
            R, A = leaf.shape
            out = torch.empty((R, A), dtype=torch.int32, device=dev)

            def call(fn):
                return fn(leaf.data_ptr(), R, A, max_len, out.data_ptr(), stream())

            ab("package_merge", name,
               {"shape": [R, A], "max_len": max_len,
                "mean_live": float((leaf < pm.BIG).sum(dim=1).float().mean())},
               call, [out], [pm.lengths_by_rank_plain(leaf, max_len)])
    if unequal:
        print(f"kernel_ab: {len(unequal)} results differ from the plain twin", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
