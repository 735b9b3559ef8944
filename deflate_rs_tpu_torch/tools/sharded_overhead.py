"""What the sharded step costs over the plain batch encoder, on one card.

The torch form of ``scripts/sharded_overhead.py``.  At world size 1 (NCCL
on the card, gloo on the CPU) the sharded step of ``parallel/sharded.py``
(``make_sharded_encoder``) pays everything the multi-card path adds to the
plain ``ChunkEncoder`` call: the device checksum partials, the size
all-gather (one rank: a copy), the used-prefix compaction and the fetch of
the meta and the compacted words.  ``--single-process`` takes the one-card
mesh of a process with no process group (no all-gather).  On the first
``--batch`` chunks of the 16 MiB mix (``utils/mix.py``), in one process and in turns, it times per
chunk (host clock between two synchronisations, median of ``--iters``
rounds after a warm one):

- ``floor``: a trivial op (one add on 8 integers);
- ``plain``: ``ChunkEncoder`` without checksums (the corpus engine's);
- ``plain_checksums``: ``ChunkEncoder`` with checksums;
- ``sharded``: the sharded step.

and prints one JSON line a batch with the overhead as the JAX script
defines it, ``(sharded - plain) / (plain - floor)``.  The step's compacted
words, block types, data bits and byte counts must equal the plain
encoder's, or the tool fails.  On the CPU the times are the host's
(``cpu_ms_per_chunk``), no device metric.

    python3 -m deflate_rs_tpu_torch.tools.sharded_overhead [--batch 16 64] [--iters 16]
    python3 -m deflate_rs_tpu_torch.tools.sharded_overhead --device cpu --batch 2 --emit 4096
    python3 -m deflate_rs_tpu_torch.tools.sharded_overhead --single-process
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist


def _same_words(shard: dict, plain: dict) -> bool:
    """The step's compacted words and meta against the plain encoder's."""
    from ..ops.compaction import used_words_host

    btype = plain["btype"].cpu().numpy()
    data_bits = plain["data_bits"].cpu().numpy()
    if not (np.array_equal(shard["btype"], btype) and np.array_equal(shard["data_bits"], data_bits)
            and np.array_equal(shard["nbytes"], (plain["total_bits"].cpu().numpy() + 7) // 8)):
        return False
    used = used_words_host(btype, data_bits)
    words = plain["words"].cpu().numpy().astype(np.uint32)
    want = np.concatenate([words[i, : used[i]] for i in range(len(used))])
    return np.array_equal(shard["cw"], want)


def overhead(batch: int, emit: int = 65536, *, iters: int = 16, device="cuda",
             data: bytes | None = None, card: str | None = None) -> dict:
    """The four times and the overhead at one batch, the step on one
    device: in an initialised process group of one rank
    (``parallel.mesh.init_distributed``), or in this process alone where
    none is initialised."""
    from ..compression_options import CompressionOptions
    from ..ops.chunk_encode import ChunkEncoder
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import make_sharded_encoder
    from ..utils.mix import mix
    from .stage_timing import batch_inputs, card_name

    grouped = dist.is_available() and dist.is_initialized()
    if grouped and dist.get_world_size() != 1:
        raise ValueError(f"sharded_overhead runs at world size 1, not {dist.get_world_size()}")
    mesh = make_mesh(device=device) if grouped else make_mesh(1, device=device)
    dev = mesh.device
    on_card = dev.type == "cuda"
    opts = CompressionOptions.default()
    bufs, hist, ns, lasts = batch_inputs(data if data is not None else mix(batch * emit),
                                         batch, emit)
    t_bufs, t_hist, t_ns, t_lasts = (torch.from_numpy(a) for a in (bufs, hist, ns, lasts))
    plain = ChunkEncoder(opts, emit).to(dev)
    plain_cs = ChunkEncoder(opts, emit, with_checksums=True).to(dev)
    step = make_sharded_encoder(mesh, opts, emit)
    x0 = torch.ones(8, dtype=torch.int32, device=dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    things = {
        "floor": lambda: x0 + 1,
        "plain": lambda: plain(t_bufs.to(dev), t_hist, t_ns, t_lasts),
        "plain_checksums": lambda: plain_cs(t_bufs.to(dev), t_hist, t_ns, t_lasts),
        "sharded": lambda: step(bufs, hist, ns, lasts),
    }
    with torch.no_grad():
        outs = {name: fn() for name, fn in things.items()}  # warm
        if not _same_words(outs["sharded"], outs["plain"]):
            raise RuntimeError(f"sharded_overhead: the step's words differ from the plain "
                               f"encoder's at B={batch}")
        ms = {name: [] for name in things}
        for _ in range(iters):
            for name, fn in things.items():
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                ms[name].append(1e3 * (time.perf_counter() - t0) / batch)
    per_chunk = {name: statistics.median(v) for name, v in ms.items()}
    p, f, s = per_chunk["plain"], per_chunk["floor"], per_chunk["sharded"]
    row = {"batch": batch, "emit": emit, "world": 1,
           "backend": dist.get_backend() if grouped else None,
           "device": str(dev), "iters": iters, "words_equal": True,
           "overhead_ms_per_chunk": s - p, "overhead": (s - p) / max(p - f, 1e-9)}
    if on_card:
        row.update(card=card or card_name(), ms_per_chunk=per_chunk)
    else:
        row["cpu_ms_per_chunk"] = per_chunk
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[16, 64])
    ap.add_argument("--emit", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--single-process", action="store_true",
                    help="no process group: the mesh of this process alone")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("sharded_overhead: no CUDA device (pass --device cpu for the CPU)", file=sys.stderr)
        return 1
    from ..parallel.mesh import init_distributed

    def rows():
        for b in a.batch:
            print(json.dumps(overhead(b, a.emit, iters=a.iters, device=a.device)), flush=True)

    if a.single_process:
        rows()
        return 0
    tmp = tempfile.mkdtemp(prefix="sharded_overhead_")
    init_distributed(f"file://{tmp}/rendezvous", 1, 0, device=a.device)
    try:
        rows()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
