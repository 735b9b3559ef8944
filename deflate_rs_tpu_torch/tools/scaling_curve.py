"""MB/s of the sharded encoder over 1, 2 and 4 cards, in each form of mesh.

The torch form of ``scripts/scaling_curve.py``, measured on cards where the
JAX script times a CPU mesh.  One input (by default the first 64 MiB of the
mix of ``utils/mix.py``) goes through the sharded step
(``parallel/sharded.py``) in steps of ``--step`` chunks of ``--emit`` bytes,
then every step's shards are spliced packed into one stream: that is one
run.  Forms of the mesh of ``n`` devices:

- ``process``: one process drives the ``n`` devices from one host thread
  (every device's encode is launched before the first fetch);
- ``ranks``: ``n`` spawned ranks of one device each (NCCL; gloo on the
  CPU); the shards go to rank 0 by ``gather_object`` and rank 0 splices.

For each form and count it prints one JSON line: MB/s of input of
``--runs`` warm runs after one warm-up (rank 0's host clock, from a barrier
to its packed stream; median, min and max), each card's peak
``max_memory_allocated`` over those runs, and each card's busy share, the
union of its kernels, copies and memsets over the wall of one more run
under ``torch.profiler``.  The packed stream must equal the one-shot
``compress_corpus`` bytes on one card at the same chunk size, or the tool
fails.  On the CPU (``--device cpu``: logical devices, gloo ranks) the
times are the host's (``cpu_*`` keys) and no device metric is printed.

    python3 -m deflate_rs_tpu_torch.tools.scaling_curve [--devices 1 2 4] [--runs 5]
    python3 -m deflate_rs_tpu_torch.tools.scaling_curve --device cpu --devices 1 2 \\
        --mb 0.0625 --emit 4096 --step 8 --runs 1 --preset fast
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

FORMS = ("process", "ranks")


@dataclasses.dataclass(frozen=True)
class Spec:
    """One input and how the step takes it: ``nbytes`` of the mix in chunks
    of ``emit`` bytes, ``step`` chunks a step, at ``preset`` (``dom_segs``
    where not 0), ``runs`` timed runs after a warm-up (none after it where
    0: one run that only checks the bytes), and a profiled run where
    ``profile``."""

    nbytes: int
    emit: int = 65536
    step: int = 256
    preset: str = "default"
    dom_segs: int = 0
    runs: int = 5
    profile: bool = True

    def options(self):
        from ..compression_options import CompressionOptions
        from ..parallel.corpus import chunk_options

        o = getattr(CompressionOptions, self.preset)()
        if self.dom_segs:
            o = dataclasses.replace(o, dom_segs=self.dom_segs)
        return chunk_options(o, self.emit)

    def data(self) -> bytes:
        from ..utils.mix import mix

        return mix(self.nbytes)


class _Payloads:
    """Chunk ``g`` of ``data`` by global row (empty past its end)."""

    def __init__(self, data: bytes, emit: int):
        self.data, self.emit = data, emit

    def __getitem__(self, g: int) -> bytes:
        return self.data[g * self.emit : (g + 1) * self.emit]


def _sync(mesh) -> None:
    for d in mesh.devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _busy_shares(prof, mesh, wall_s: float) -> list:
    """Each card's busy share of ``wall_s``: the union of its device
    activities in the trace."""
    from torch.autograd import DeviceType

    from .corpus_profile import _busy_us

    spans = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.setdefault(e.device_index, []).append((e.time_range.start, e.time_range.end))
    return [_busy_us(spans.get(d.index, [])) / 1e6 / wall_s for d in mesh.devices]


def run_spec(mesh, spec: Spec) -> dict:
    """This process's part of the runs of ``spec`` on ``mesh``: its walls (of
    rank 0 where there are ranks), its cards' peaks and busy shares, and on
    rank 0 the packed stream's length and sha256."""
    from ..parallel.sharded import assemble_host, make_sharded_encoder
    from .dryrun_multichip import build_batch

    data = spec.data()
    step = make_sharded_encoder(mesh, spec.options(), spec.emit)
    bufs, hist, ns, lasts = build_batch(data, spec.emit)
    n_chunks = len(ns)
    if n_chunks % spec.step or spec.step % mesh.size:
        raise ValueError(f"{n_chunks} chunks do not split into steps of {spec.step} over "
                         f"{mesh.size} devices")
    payloads = _Payloads(data, spec.emit)
    grouped = mesh.group is not None
    rank0 = mesh.rank == 0

    def run():
        shards = []
        for g0 in range(0, n_chunks, spec.step):
            rows = slice(g0, g0 + spec.step)
            shard = step(bufs[rows], hist[rows], ns[rows], lasts[rows])
            shard["row0"] += g0
            shards.append(shard)
        if grouped:
            every = [None] * dist.get_world_size() if rank0 else None
            dist.gather_object(shards, every, dst=0)
            if not rank0:
                return None
            shards = sorted((s for part in every for s in part), key=lambda s: s["row0"])
        # Every step's shards as rows of one batch over the whole input.
        all_nbytes = np.concatenate([s["nbytes"] for s in shards])
        return assemble_host([dict(s, all_nbytes=all_nbytes) for s in shards], n_chunks,
                             packed=True, payloads=payloads, is_lasts=lasts)

    def timed(fn):
        _sync(mesh)
        if grouped:
            dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        _sync(mesh)
        return out, time.perf_counter() - t0

    on_card = mesh.device.type == "cuda"
    if on_card:
        for d in mesh.devices:
            torch.cuda.reset_peak_memory_stats(d)
    packed, wall = timed(run)
    walls = [wall] if not spec.runs else []
    for _ in range(spec.runs):
        packed, wall = timed(run)
        walls.append(wall)
    out = {"walls": walls}
    if on_card:
        out["peak_gib"] = [torch.cuda.max_memory_allocated(d) / 2**30 for d in mesh.devices]
        if spec.profile:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                _, wall = timed(run)
            out["busy_share"] = _busy_shares(prof, mesh, wall)
            out["profiled_wall_s"] = wall
    if packed is not None:
        out["packed_bytes"] = len(packed)
        out["packed_sha256"] = hashlib.sha256(packed).hexdigest()
    return out


def _rank_specs(mesh, specs: tuple) -> list:
    """A spawned rank: every spec in turn."""
    return [run_spec(mesh, spec) for spec in specs]


def run_form(form: str, n: int, specs, *, device="cuda", local_devices: int = 1) -> list:
    """Every spec over a mesh of ``n`` devices in ``form`` (``ranks`` with
    ``local_devices`` devices a rank); one result per spec: rank 0's, with
    the peaks and busy shares of every card in mesh order."""
    from ..parallel.mesh import make_mesh
    from .dryrun_multichip import spawn_ranks

    if form not in FORMS:
        raise ValueError(f"form {form!r} is none of {FORMS}")
    if form != "ranks":
        mesh = make_mesh(n, device=device)
        return [dict(run_spec(mesh, s), processes=1) for s in specs]
    if n % local_devices:
        raise ValueError(f"{n} devices do not split into ranks of {local_devices}")
    ranks = spawn_ranks(_rank_specs, n // local_devices, (tuple(specs),), device=device,
                        local_devices=local_devices)
    results = []
    for i in range(len(specs)):
        res = dict(ranks[0][i], processes=len(ranks))
        for key in ("peak_gib", "busy_share"):
            if key in res:
                res[key] = [v for r in ranks for v in r[i][key]]
        results.append(res)
    return results


def one_shot(spec: Spec, device="cuda") -> bytes:
    """The one-shot ``compress_corpus`` bytes of ``spec``'s input on one
    device, at its chunk size."""
    from ..parallel.corpus import compress_corpus

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return compress_corpus(spec.data(), spec.options(), chunk_size=spec.emit, device=dev).deflate


def row(form: str, n: int, spec: Spec, res: dict, want: bytes, card: str | None) -> dict:
    """One printed line; raises ``RuntimeError`` where the packed stream is
    not the one-shot stream."""
    if (res["packed_bytes"], res["packed_sha256"]) != (len(want),
                                                      hashlib.sha256(want).hexdigest()):
        raise RuntimeError(f"scaling_curve: {form} at {n} devices: the packed stream "
                           f"({res['packed_bytes']} B) differs from the one-shot bytes "
                           f"({len(want)} B)")
    rates = [spec.nbytes / 1e6 / w for w in res["walls"]]
    out = {"form": form, "devices": n, "processes": res["processes"], "emit": spec.emit,
           "step_chunks": spec.step, "preset": spec.preset, "dom_segs": spec.dom_segs,
           "input_bytes": spec.nbytes, "runs": len(rates), "packed_bytes": res["packed_bytes"],
           "equal_one_shot": True}
    prefix = "" if card else "cpu_"
    out[f"{prefix}mb_per_s"] = rates
    out[f"{prefix}mb_per_s_median"] = statistics.median(rates)
    out[f"{prefix}mb_per_s_min"], out[f"{prefix}mb_per_s_max"] = min(rates), max(rates)
    if card:
        out["card"], out["cards_seen"] = card, torch.cuda.device_count()
        out["peak_gib"] = res["peak_gib"]
        if "busy_share" in res:
            out["busy_share"] = res["busy_share"]
            out["profiled_wall_s"] = res["profiled_wall_s"]
    return out


def curve(devices, forms, spec: Spec, *, device="cuda", card: str | None = None):
    """Yield one row a form and device count (see :func:`row`)."""
    want = one_shot(spec, device)
    for n in devices:
        for form in forms:
            (res,) = run_form(form, n, [spec], device=device)
            yield row(form, n, spec, res, want, card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--forms", nargs="+", default=list(FORMS), choices=FORMS)
    ap.add_argument("--mb", type=float, default=64, help="MiB of the mix")
    ap.add_argument("--emit", type=int, default=65536, help="chunk size in bytes")
    ap.add_argument("--step", type=int, default=256, help="chunks a step")
    ap.add_argument("--runs", type=int, default=5, help="timed runs after a warm one")
    ap.add_argument("--preset", default="default",
                    choices=("default", "fast", "high", "rle", "huffman_only", "turbo"))
    ap.add_argument("--dom-segs", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("scaling_curve: no CUDA device (pass --device cpu for the CPU)", file=sys.stderr)
        return 1
    card = None
    if a.device == "cuda":
        from .stage_timing import card_name

        card = card_name()
    else:
        torch.set_num_threads(1)
    spec = Spec(int(a.mb * (1 << 20)), a.emit, a.step, a.preset, a.dom_segs, a.runs,
                profile=a.device == "cuda")
    for r in curve(a.devices, a.forms, spec, device=a.device, card=card):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
