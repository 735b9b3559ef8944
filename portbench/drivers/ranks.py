"""The ``ranks`` form: one rank a card, the sharded encoder
(``parallel/sharded.py``) over a process group, rank 0 splicing.

A job is ``job_bytes`` of the mix on the chunk grid, encoded in steps of
``step_chunks`` chunks over the ranks (``make_sharded_encoder``); the
steps' shards go to rank 0 by ``gather_object``, and rank 0 splices them
packed (``assemble_host(packed=True)``) and frames the zlib stream with the
Adler-32 that it folds from the device checksums of every chunk.  Rank 0's
clock runs the window, from a barrier to each job's stream; rank 0 tells
the others by a broadcast whether another job follows.

The launcher (``run``) builds the program once, starts the ranks with
``procs.launch`` and reaps them all before it returns.  A rank is this
module run as ``python -m portbench.drivers.ranks <dir> <rank> <pid>``; its
imports here are the standard library's, so that it arranges to die with
the launcher before it loads anything else.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

from .. import procs
from ..spec import ROOT, forbidden_modules

# Seconds a rank may take beyond the window: imports, the process group,
# the pool, the warm-up, the traced job's reading, the check.
RANK_ALLOWANCE_S = 150
HALO, PAD = 32768, 72  # a chunk's history and tail padding (ops/chunk_encode.py)


def launch_runs(cell, seeds, seconds: float, trace_on: bool, *, device="cuda",
                config: dict | None = None, entry: str = __name__, on_start=None) -> list:
    """Run the cell once a seed in one launch of ``cell.chips`` ranks (the
    ranks keep their set-up from one seed to the next) and return rank 0's
    run of each seed, combined with the other ranks' cards.  ``config``
    stands in for the cell's configuration (the control's preset)."""
    from .. import program

    program.build(device)  # once, before any rank loads it
    spec = {"config": config or cell.config, "traffic": cell.traffic, "check": cell.check,
            "seeds": [int(s) for s in seeds], "seconds": seconds, "trace": trace_on,
            "device": str(device)}
    world = cell.chips
    results = procs.launch(entry, world, spec,
                           RANK_ALLOWANCE_S + len(seeds) * (seconds + RANK_ALLOWANCE_S),
                           cwd=ROOT, on_start=on_start)
    found = sorted({m for r in results for m in r["modules"]})
    if found:
        raise RuntimeError(f"a rank loaded {found}")
    runs = []
    for i, run in enumerate(results[0]["runs"]):
        cards = [r["runs"][i] for r in results]
        run = dict(run, peak_bytes=max(c["peak_bytes"] for c in cards), cards=world)
        if run["trace"] is not None:
            run["trace"]["cards"] = [
                {"busy_s": c.get("busy_s"), "window_s": c.get("trace_window_s")} for c in cards]
        runs.append(run)
    return runs


def run(cell, seed: int, seconds: float, trace_on: bool, *, started: float,
        device="cuda") -> dict:
    """One run (see ``portbench/run.py`` for the keys of the result)."""
    (one,) = launch_runs(cell, [seed], seconds, trace_on, device=device)
    one["setup_s"] = one.pop("window_start_wall") - started
    return one


class Rows:
    """The pool's chunks as the sharded step takes them: uint8 rows of 32 KiB
    of history, the chunk and the zero padding, with each job's first rows
    cut anew so that its history starts with the job."""

    def __init__(self, pool: bytes, chunk: int, job_chunks: int, step: int):
        import numpy as np

        self.E, self.n, self.S = chunk, job_chunks, step
        src = np.frombuffer(pool, np.uint8)
        self.src = src
        P = len(src) // chunk
        padded = np.concatenate([np.zeros(HALO, np.uint8), src])
        win = np.lib.stride_tricks.sliding_window_view(padded, HALO + chunk)[::chunk][:P]
        self.bufs = np.zeros((P, HALO + chunk + PAD), np.uint8)
        self.bufs[:, : HALO + chunk] = win
        self.ns = np.full(step, chunk, np.int64)
        self.lasts = [np.zeros(step, bool) for _ in range(0, job_chunks, step)]
        self.lasts[-1][-1] = True
        self.hist = [np.minimum((s0 + np.arange(step)) * chunk, HALO).astype(np.int64)
                     for s0 in range(0, job_chunks, step)]

    def step_rows(self, start_chunk: int, k: int):
        """(bufs, hist, ns, lasts) of step ``k`` of the job that starts at
        chunk ``start_chunk``."""
        import numpy as np

        s0 = k * self.S
        bufs = self.bufs[start_chunk + s0 : start_chunk + s0 + self.S]
        hist = self.hist[k]
        short = np.nonzero(hist < HALO)[0]
        if len(short):
            bufs = bufs.copy()
            for i in short:
                off = (start_chunk + s0 + i) * self.E
                h = int(hist[i])
                bufs[i, : HALO - h] = 0
                bufs[i, HALO - h : HALO] = self.src[off - h : off]
        return bufs, hist, self.ns, self.lasts[k]


class _Payloads:
    """Chunk ``g`` of a job's bytes by global row (the stored chunks')."""

    def __init__(self, data: bytes, chunk: int):
        self.data, self.chunk = data, chunk

    def __getitem__(self, g: int) -> bytes:
        return self.data[g * self.chunk : (g + 1) * self.chunk]


def serve(mesh, spec: dict, seed: int, gather=None) -> dict:
    """One seed's run on this rank: set-up, the window, the traced jobs.
    ``gather(shards, mesh)`` is the exchange (by default ``gather_shards``)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from deflate_rs_tpu_torch import constants as C
    from deflate_rs_tpu_torch.ops import checksum
    from deflate_rs_tpu_torch.parallel.corpus import chunk_options
    from deflate_rs_tpu_torch.parallel.sharded import assemble_host, make_sharded_encoder

    from .. import program, trace
    from ..traffic import Jobs, Sample

    gather = gather or gather_shards
    config, traffic = spec["config"], spec["traffic"]
    E, S = config["chunk_size"], config["step_chunks"]
    device = mesh.device
    rank0 = mesh.rank == 0
    jobs = Jobs(traffic, seed, grain=E)
    n = jobs.job_bytes // E
    if jobs.job_bytes % E or n % S or S % mesh.size:
        raise ValueError(f"a job of {jobs.job_bytes} B is not whole steps of {S} chunks of "
                         f"{E} B over {mesh.size} ranks")
    rows = Rows(jobs.pool, E, n, S)
    step = make_sharded_encoder(mesh, chunk_options(program.options_of(config), E), E)
    lasts = np.zeros(n, bool)
    lasts[-1] = True
    flag_device = device if device.type == "cuda" else torch.device("cpu")

    def one_job(start: int):
        """This rank's part of one job; on rank 0 the job's zlib stream and
        the seconds of its gather and splice."""
        c = start // E
        shards = []
        for k in range(n // S):
            with torch.profiler.record_function("portbench.step"):
                shard = step(*rows.step_rows(c, k))
            shard["row0"] += k * S
            shards.append(shard)
        t = time.perf_counter()
        with torch.profiler.record_function("portbench.gather"):
            shards = gather(shards, mesh)
        if not rank0:
            return None, 0.0
        with torch.profiler.record_function("portbench.splice"):
            all_nbytes = np.concatenate([s["nbytes"] for s in shards])
            body = assemble_host([dict(s, all_nbytes=all_nbytes) for s in shards], n,
                                 packed=True, payloads=_Payloads(jobs.data(start), E),
                                 is_lasts=lasts)
            adler = checksum.ADLER_INIT
            for s in shards:
                for s1, s2 in zip(s["s1"], s["s2"]):
                    adler = checksum.adler32_combine(adler, int(s1), int(s2), E)
            stream = (C.zlib_header() + body
                      + checksum.adler32_value(adler).to_bytes(4, "big"))
        return stream, time.perf_counter() - t

    def go_on(flag: bool) -> bool:
        """Rank 0's word on whether another job follows."""
        t = torch.tensor([int(flag)], device=flag_device)
        dist.broadcast(t, src=0)
        return bool(t.item())

    for _ in range(traffic["warmup_jobs"]):
        one_job(jobs.next_start())
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    sample = Sample(spec["check"]["sample_jobs"], seed)
    traced = trace.Traced(traffic["trace_jobs"] if spec["trace"] else 0, device,
                          jobs.job_bytes, config)
    attempted = failed = done = 0
    errors, serial = [], []
    dist.barrier()
    t0, wall0 = time.perf_counter(), time.time()
    while go_on(not failed and (time.perf_counter() - t0 < spec["seconds"]
                                or traced.pending(attempted))):
        start = jobs.next_start()
        traced.before(attempted)
        attempted += 1
        try:
            stream, serial_s = one_job(start)
        except Exception as e:  # rank 0's splice of a wrong exchange, say
            if not rank0:
                raise
            failed += 1
            errors.append(f"{type(e).__name__}: {e}")
            continue
        done += jobs.job_bytes
        if rank0:
            sample.offer(start, stream)
            serial.append(serial_s * 1e3)
        traced.after(attempted)
    traced.close()
    program.sync(device)
    window = time.perf_counter() - t0
    rec = traced.record
    out = {"peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}
    if rec is not None:
        out.update(busy_s=trace.device_seconds(rec), trace_window_s=rec["window_s"])
    if rank0:
        if rec is not None:
            rec["serial_ms"] = serial
        out.update(attempted=attempted, failed=failed, errors=errors, bytes_done=done,
                   window_s=window, window_start_wall=wall0, trace=rec,
                   samples=[(s, stream) for _, s, stream in sample.kept],
                   seed=seed)
    return out


def gather_shards(shards: list, mesh) -> list | None:
    """Every rank's shards on rank 0, in row order (None elsewhere)."""
    import torch.distributed as dist

    every = [None] * dist.get_world_size() if mesh.rank == 0 else None
    dist.gather_object(shards, every, dst=0)
    if mesh.rank != 0:
        return None
    return sorted((s for part in every for s in part), key=lambda s: s["row0"])


def rank_main(argv: list, gather=None) -> None:
    """A rank: join the group, serve each seed, leave the group, and (rank
    0) check the sampled streams once the program's work is done."""
    tmp, rank, spec = procs.rank_args(argv)
    try:
        import torch
        import torch.distributed as dist
        from deflate_rs_tpu_torch.parallel.mesh import init_distributed, make_mesh

        from .. import reference
        from ..traffic import Jobs

        device = spec["device"]
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # the ranks share the host's cores
        init_distributed(f"file://{spec['rendezvous']}", spec["world"], rank, device=device)
        mesh = make_mesh(device=device)
        runs = [serve(mesh, spec, seed, gather) for seed in spec["seeds"]]
        dist.destroy_process_group()
        if rank == 0:
            E = spec["config"]["chunk_size"]
            for run in runs:
                jobs = Jobs(spec["traffic"], run["seed"], grain=E)
                run["numbers"] = reference.check(
                    [(jobs.data(s), stream) for s, stream in run.pop("samples")], E,
                    spec["check"]["reference_level"])
        procs.write_result(tmp, rank, {"rank": rank, "pid": os.getpid(), "runs": runs,
                                       "modules": forbidden_modules()})
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


if __name__ == "__main__":
    rank_main(sys.argv[1:])
