"""A/B timing of two versions of the parse_scan and package_merge kernels.

Times from different runs on different cards differ by more than these
kernels' gaps, so the old and the new sources are built into two libraries
and timed in one process on the same operands, in turns (old, new, new,
old).  Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m deflate_rs_tpu_torch.tools.kernel_ab --old-csrc DIR [--iters 200]

``DIR`` holds the older ``parse_scan.cu`` and ``package_merge.cu`` (for
example ``git show <commit>:deflate_rs_tpu_torch/csrc/parse_scan.cu``); the
new ones are the package's own.  Operands: the Default encoder's inputs at
32 chunks of 64 KiB (harvested as ``chip_smoke.py`` does), the ``high``
encoder's package-merge rows (2,304 x 286), and adversarial batches of
``utils/kernel_cases.py``.  Both versions must equal the plain twin.

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
    ap.add_argument("--old-csrc", required=True)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke
    import deflate_rs_tpu_torch as dt
    from deflate_rs_tpu_torch.models.deflate import _chunk_buffers
    from deflate_rs_tpu_torch.ops import parse_scan as ps
    from deflate_rs_tpu_torch.ops import pm_kernel as pm
    from deflate_rs_tpu_torch.ops.chunk_encode import ChunkEncoder
    from deflate_rs_tpu_torch.runtime import cuda
    from deflate_rs_tpu_torch.utils import kernel_cases

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "iters": args.iters}))
    names = ["parse_scan.cu", "package_merge.cu"]
    tmp = os.path.join(cuda.BUILD_DIR, "kernel_ab")
    os.makedirs(tmp, exist_ok=True)
    libs = {
        "old": _build(cuda._nvcc(), cuda.NVCC_FLAGS, [os.path.join(args.old_csrc, n) for n in names],
                      os.path.join(tmp, "libold.so")),
        "new": _build(cuda._nvcc(), cuda.NVCC_FLAGS, [os.path.join(cuda.CSRC_DIR, n) for n in names],
                      os.path.join(tmp, "libnew.so")),
    }
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.parse_scan.argtypes = [P, P, I, I, P, P]
        lib.package_merge.argtypes = [P, I, I, I, P, P]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(err, what):
        if err != 0:
            raise SystemExit(f"{what}: launch error {err}")

    unequal = []

    # ----------------------------------------------------------- operands
    with open(os.path.join(root, "tests", "data", "pg11.txt"), "rb") as f:
        mix = chip_smoke.build_mix(chip_smoke.MIX_BYTES, f.read())
    bufs, hist, ns, last = _chunk_buffers(mix, [i * 65536 for i in range(32)], 65536)
    seen = {}
    for name, o in (("default", dt.CompressionOptions.default()),
                    ("high", dt.CompressionOptions.high())):
        with torch.no_grad():
            seen[name] = chip_smoke.harvest(
                ChunkEncoder(o, 65536).to(dev), torch.from_numpy(bufs).to(dev),
                torch.from_numpy(hist), torch.from_numpy(ns), torch.from_numpy(last))
    parse_ops = {"default": seen["default"]["parse_scan"]}
    for pattern in ("max", "never_converge", "uniform"):
        rng = np.random.default_rng(7)
        steps = np.stack([kernel_cases.parse_steps(pattern, rng, 65536) for _ in range(32)])
        parse_ops[pattern] = (torch.from_numpy(steps).to(dev),
                              torch.full((32,), 65536, dtype=torch.int32, device=dev))
    pm_ops = {
        "default_512x286_at_15": seen["default"]["lengths_by_rank_15"],
        "default_256x19_at_7": seen["default"]["lengths_by_rank_7"],
        "high_2304x286_at_15": seen["high"]["lengths_by_rank_15"],
    }
    for name, freqs, max_len in kernel_cases.package_merge_cases():
        if name in ("mixed_2304x286", "m_sweep_286"):
            pm_ops[name] = (torch.from_numpy(kernel_cases.sorted_leaves(freqs)).to(dev), max_len)

    # --------------------------------------------------------- parse_scan
    for name, (steps, n) in parse_ops.items():
        B, E = steps.shape
        want = ps.parse_scan_plain(steps, n)
        out = torch.empty((B, E), dtype=torch.bool, device=dev)

        def run(which):
            check(libs[which].parse_scan(steps.data_ptr(), n.data_ptr(), B, E, out.data_ptr(),
                                         stream()), f"{which} parse_scan")

        for which in ("old", "new", "new", "old"):
            out.zero_()
            run(which)
            torch.cuda.synchronize()
            row = {"kernel": "parse_scan", "operands": name, "shape": [B, E],
                   "version": which, "equal": bool(torch.equal(out, want))}
            row.update(_times(torch, lambda: run(which), args.iters))
            print(json.dumps(row), flush=True)
            if not row["equal"]:
                unequal.append(row)

    # ------------------------------------------------------ package_merge
    for name, (leaf, max_len) in pm_ops.items():
        R, A = leaf.shape
        want = pm.lengths_by_rank_plain(leaf, max_len)
        out = torch.empty((R, A), dtype=torch.int32, device=dev)
        live = (leaf < pm.BIG).sum(dim=1)

        def run(which):
            check(libs[which].package_merge(leaf.data_ptr(), R, A, max_len, out.data_ptr(),
                                            stream()), f"{which} package_merge")

        for which in ("old", "new", "new", "old"):
            out.zero_()
            run(which)
            torch.cuda.synchronize()
            row = {"kernel": "package_merge", "operands": name, "shape": [R, A],
                   "max_len": max_len, "mean_live": float(live.float().mean()),
                   "version": which, "equal": bool(torch.equal(out, want))}
            row.update(_times(torch, lambda: run(which), args.iters))
            print(json.dumps(row), flush=True)
            if not row["equal"]:
                unequal.append(row)
    if unequal:
        print(f"kernel_ab: {len(unequal)} results differ from the plain twin", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
