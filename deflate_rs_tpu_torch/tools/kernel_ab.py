"""A/B timing of two versions of the redesigned CUDA kernels.

Times from different runs on different cards differ by more than these
kernels' gaps, so the old and the new sources are built into two libraries
and timed in one process on the same operands, in turns (old, new, new,
old).  Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m deflate_rs_tpu_torch.tools.kernel_ab --old-csrc DIR [DIR ...] \\
        [--kernels lr_measure,quarter_hist,parse_scan,package_merge] [--iters 200]

``DIR`` holds the older ``<kernel>.cu`` of every kernel named (for example
``git show <commit>:deflate_rs_tpu_torch/csrc/lr_measure.cu``); the new ones
are the package's own.  Several directories (steps of a redesign) are timed
in the order given, then the new sources, then all again in reverse.
Operands:

- ``lr_measure``: the Default encoder's inputs at 32 and 64 chunks of 64 KiB
  (64 segments; 64 chunks is the corpus engine's batch), the ``high``
  encoder's (32 segments), Default's in the 4 KiB tier, one chunk alone, and
  two adversarial batches (every pattern mixed; all-zero buffers, where every
  live dominant ties over the whole window), all on the block path;
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
card's time alone).  It prints one JSON object per line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

KERNELS = ("lr_measure", "quarter_hist", "parse_scan", "package_merge")


def _build(nvcc: str, flags: list, sources: list, out: str) -> ctypes.CDLL:
    proc = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-o", out, *sources],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {sources}:\n{proc.stdout}\n{proc.stderr}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    return ctypes.CDLL(out)


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
    args = ap.parse_args()
    chosen = args.kernels.split(",")
    if not chosen or any(k not in KERNELS for k in chosen):
        ap.error(f"--kernels takes names of {KERNELS}")

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
    names = [f"{k}.cu" for k in chosen]
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
    P, I = ctypes.c_void_p, ctypes.c_int
    argtypes = {
        "lr_measure": [P, I, P, I, I, I, I, I, P, P, P, P],
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

    def ab(kernel: str, operands: str, info: dict, call, outs, want) -> None:
        """Time ``call(lib_fn)`` old, new, new, old; ``outs`` (overwritten
        before each turn's first launch) must equal ``want``."""
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
    for emit in (65536, 4096) if "lr_measure" in chosen else (65536,):
        bufs, hist, ns, last = chip_smoke.tier_buffers(mix, emit)
        for name, o in wanted.items():
            if emit == 4096 and name != "default":
                continue
            with torch.no_grad():
                seen[name, emit] = chip_smoke.harvest(
                    ChunkEncoder(o, emit).to(dev), torch.from_numpy(bufs).to(dev),
                    torch.from_numpy(hist), torch.from_numpy(ns), torch.from_numpy(last))

    if "lr_measure" in chosen:  # and the corpus engine's batch, 64 chunks
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
