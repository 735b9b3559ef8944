"""The ``corpus`` form: one process on one card, a closed loop of jobs, each
one call of the corpus engine (``parallel/corpus.py``) that returns a zlib
stream.

``compress_corpus_zlib`` takes no chunk size or queue depth, so a job calls
``compress_corpus`` with the configuration's and frames its DEFLATE body as
``compress_corpus_zlib`` does: the program's zlib header, the body, the
program's Adler-32.
"""

from __future__ import annotations

import os
import time

from .. import program, reference, trace
from ..traffic import Jobs, Sample


def encoder(config: dict, device):
    """The timed path: a job's bytes to its zlib stream."""
    from deflate_rs_tpu_torch import constants as C
    from deflate_rs_tpu_torch.parallel import corpus

    options = program.options_of(config)

    def encode(data: bytes) -> bytes:
        res = corpus.compress_corpus(
            data, options, batch_size=config["batch_size"], packed=True,
            queue_depth=config["queue_depth"], chunk_size=config["chunk_size"], device=device)
        return C.zlib_header() + res.deflate + res.adler.to_bytes(4, "big")

    return encode


def run(cell, seed: int, seconds: float, trace_on: bool, *, started: float,
        device="cuda") -> dict:
    """One run: set-up, the window, then the check (see ``portbench/run.py``
    for the keys of the result)."""
    import torch

    config, traffic = cell.config, cell.traffic
    jobs = Jobs(traffic, seed)
    sample = Sample(cell.check["sample_jobs"], seed)
    program.build(device)
    encode = encoder(config, device)
    for _ in range(traffic["warmup_jobs"]):
        encode(jobs.data(jobs.next_start()))
    if trace_on:
        os.environ["DEFLATE_TPU_TRACE_CORPUS"] = "1"  # the program's corpus.* ranges
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    traced = trace.Traced(traffic["trace_jobs"] if trace_on else 0, device, jobs.job_bytes,
                          config)
    attempted = failed = done = 0
    errors = []
    t0, wall0 = time.perf_counter(), time.time()
    while time.perf_counter() - t0 < seconds or traced.pending(attempted):
        start = jobs.next_start()
        data = jobs.data(start)
        traced.before(attempted)
        attempted += 1
        try:
            out = encode(data)
        except Exception as e:  # a job that raises never answers: the run fails
            failed += 1
            errors.append(f"{type(e).__name__}: {e}")
            break
        done += len(data)
        sample.offer(start, out)
        traced.after(attempted)
    traced.close()
    program.sync(device)
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    numbers = reference.check([(jobs.data(s), out) for _, s, out in sample.kept],
                              config["chunk_size"], cell.check["reference_level"])
    return {"attempted": attempted, "failed": failed, "errors": errors, "bytes_done": done,
            "window_s": window, "setup_s": wall0 - started, "peak_bytes": peak,
            "cards": 1, "numbers": numbers, "trace": traced.record}
