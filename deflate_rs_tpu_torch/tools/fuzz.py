"""Structure-guided mutation fuzzer for the encoder, on the card.

The torch form of ``scripts/fuzz.py``, with its own copies of
``structure_key``, ``seeds`` and ``mutate``: the same rng calls in the same
order, so one ``--seed`` gives the same mutants as the JAX script.  The
feedback map is the encoder's observable structure (each chunk's block
type, token-count and output-size buckets, the chunk count, per preset): a
mutant that lights up a new structure tuple joins the live corpus, as a new
edge does in AFL, so the corpus grows toward rare encoder paths
(stored/Huffman boundaries, split seams, RLE runs, tiny tails).

Every input goes through ``ChunkEncoder`` at every preset, all its chunks as
one batch, spliced on the host (``models/assembly.py``), and must pass:

- ``zlib.decompress(stream, -15) == data``;
- the port's own ``inflate`` gives ``data`` back;
- every 8th input of more than one chunk also round-trips through
  ``compress_corpus`` at batch sizes 2, 3 and 5 in turn (first preset);
- with ``--compare-cpu N``, on the first N inputs of at most 70,000 B, the
  bytes and structure equal the CPU port's.

Failing inputs are written to ``--out`` (by default
``deflate_rs_tpu_torch/build/fuzz_failures``, which git ignores) as
``fail_<k>_<preset>.bin``; any failure exits non-zero.  Replay one with
``--replay FILE [FILE ...]``, which runs the same checks on those inputs
alone.

    python3 -m deflate_rs_tpu_torch.tools.fuzz --iters 200 --compare-cpu 10
    python3 -m deflate_rs_tpu_torch.tools.fuzz --iters 50 --presets high,rle,huffman_only
    python3 -m deflate_rs_tpu_torch.tools.fuzz --iters 20 --device cpu
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import zlib
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np
import torch

from ..utils.mix import pg11

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(REPO, "deflate_rs_tpu_torch", "build", "fuzz_failures")
COMPARE_MAX_LEN = 70_000


def structure_key(out_meta, preset_name: str) -> tuple:
    """Feedback map: the encoder-structure 'coverage' tuple of one input."""
    btypes, ntoks, sizes = out_meta
    tok_bucket = tuple(min(7, int(t).bit_length() // 2) for t in ntoks[:8])
    size_bucket = tuple(min(7, int(s).bit_length() // 2) for s in sizes[:8])
    return (preset_name, tuple(btypes[:8]), tok_bucket, size_bucket, len(btypes))


def encode_with_structure(data: bytes, options, *, device="cuda"):
    """Compress ``data`` through the chunk encoder, all its chunks as one
    batch; returns (stream, (btypes, ntokens, data_bits) per chunk)."""
    from ..models.assembly import BitAssembler, splice_encoded_chunk
    from ..models.deflate import FULL_EMIT, SMALL_EMIT, _chunk_buffers, get_chunk_encoder

    n = len(data)
    emit = SMALL_EMIT if n <= SMALL_EMIT else FULL_EMIT
    encoder = get_chunk_encoder(options, emit, str(torch.device(device)))
    offsets = list(range(0, n, FULL_EMIT)) if n else [0]
    bufs, hist, ns, last = _chunk_buffers(data, offsets, emit)
    with torch.no_grad():
        out = encoder(torch.from_numpy(bufs).to(device), torch.from_numpy(hist),
                      torch.from_numpy(ns), torch.from_numpy(last))
    words = out["words"].cpu().numpy()
    meta = torch.stack([out["btype"], out["ntokens"], out["data_bits"]]).cpu().numpy()
    asm = BitAssembler(n + n // 128 + 4096)
    for i, off in enumerate(offsets):
        splice_encoded_chunk(asm, int(meta[0, i]), int(meta[2, i]), words[i],
                             data[off : off + int(ns[i])], bool(last[i]))
    return asm.take_aligned(), tuple([int(v) for v in row] for row in meta)


def seeds(rng) -> list[bytes]:
    out = []
    afl = os.path.join(REPO, "tests", "data", "afl")
    if os.path.isdir(afl):
        for name in sorted(os.listdir(afl)):
            with open(os.path.join(afl, name), "rb") as f:
                out.append(f.read())
    text = pg11()
    out += [
        b"",
        b"x",
        text[:70_000],
        b"\x00" * 65_537,
        bytes(rng.integers(0, 256, 40_000, dtype=np.uint8)),
        (b"ab" * 9000),
        text[:32768] + bytes(rng.integers(0, 256, 32768, dtype=np.uint8)),
    ]
    return out


def mutate(rng, corpus: list[bytes], max_len: int) -> bytes:
    a = corpus[int(rng.integers(0, len(corpus)))]
    op = int(rng.integers(0, 8))
    b = bytearray(a)
    if op == 0 and b:  # byte flips
        for _ in range(int(rng.integers(1, 16))):
            b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
    elif op == 1:  # insert random span
        pos = int(rng.integers(0, len(b) + 1))
        b[pos:pos] = bytes(rng.integers(0, 256, int(rng.integers(1, 4096)), dtype=np.uint8))
    elif op == 2 and b:  # delete span
        lo = int(rng.integers(0, len(b)))
        b[lo : lo + int(rng.integers(1, 4096))] = b""
    elif op == 3:  # splice two corpus entries
        c = corpus[int(rng.integers(0, len(corpus)))]
        cut_a, cut_c = int(rng.integers(0, len(b) + 1)), int(rng.integers(0, len(c) + 1))
        b = bytearray(bytes(b[:cut_a]) + c[cut_c:])
    elif op == 4 and b:  # repeat a window (manufactures long matches)
        lo = int(rng.integers(0, len(b)))
        w = bytes(b[lo : lo + int(rng.integers(1, 1024))])
        b[lo:lo] = w * int(rng.integers(2, 30))
    elif op == 5:  # run injection (RLE paths)
        pos = int(rng.integers(0, len(b) + 1))
        b[pos:pos] = bytes([int(rng.integers(0, 256))]) * int(rng.integers(3, 70_000))
    elif op == 6:  # resize to boundary-adjacent length
        target = [4095, 4096, 4097, 65535, 65536, 65537, 131072, 98304][int(rng.integers(0, 8))]
        b = bytearray((bytes(b) * (target // max(1, len(b)) + 1))[:target + int(rng.integers(0, 3)) - 1])
    else:  # arithmetic on a few bytes
        for _ in range(int(rng.integers(1, 8))):
            if not b:
                break
            i = int(rng.integers(0, len(b)))
            b[i] = (b[i] + int(rng.integers(-4, 5))) % 256
    return bytes(b[:max_len])


def _inflate_check(stream: bytes, data: bytes) -> str | None:
    """Why the port's ``inflate`` of ``stream`` is not ``data`` (None if it is)."""
    from ..models.inflate import inflate

    try:
        return None if inflate(stream) == data else "the port's inflate does not give the input back"
    except Exception as e:  # noqa: BLE001 - any fault is a finding
        return f"the port's inflate raised {type(e).__name__}: {e}"


class Fuzzer:
    """The checks of one run and what they found; ``run_one`` takes an input.

    On the card the port's ``inflate`` (pure Python, the slowest check) runs
    in a pool of spawned processes while the card encodes the next inputs;
    ``close`` waits for every one of them.  On the CPU it runs inline."""

    def __init__(self, presets: dict, *, device="cuda", compare_cpu: int = 0, out: str = OUT):
        self.presets = presets
        self.device = device
        on_card = torch.device(device).type == "cuda"
        self.compare_left = compare_cpu if on_card else 0
        self.out = out
        self.seen: set = set()
        self.failures: list = []
        self.inputs = self.compared = self.corpus_checks = 0
        self.workers = min(6, max(1, (os.cpu_count() or 2) - 2)) if on_card else 0
        self.pool = (ProcessPoolExecutor(self.workers, mp_context=get_context("spawn"))
                     if self.workers else None)
        self.pending = collections.deque()  # (tag, data, future of _inflate_check)

    def _fail(self, tag: str, data: bytes, why: str) -> None:
        self.failures.append((tag, len(data), why))
        os.makedirs(self.out, exist_ok=True)
        path = os.path.join(self.out, f"fail_{len(self.failures)}_{tag}.bin")
        with open(path, "wb") as f:
            f.write(data)
        print(f"FAILURE at {tag}, len={len(data)}: {why} (saved to {path})", flush=True)

    def _drain(self, keep: int) -> None:
        """Read the pool's results, oldest first, until ``keep`` are pending
        (and any that are done)."""
        while self.pending and (len(self.pending) > keep or self.pending[0][2].done()):
            tag, data, fut = self.pending.popleft()
            why = fut.result()
            if why is not None:
                self._fail(tag, data, why)

    def _check_inflate(self, tag: str, data: bytes, stream: bytes) -> None:
        if self.pool is None:
            why = _inflate_check(stream, data)
            if why is not None:
                self._fail(tag, data, why)
            return
        self.pending.append((tag, data, self.pool.submit(_inflate_check, stream, data)))
        self._drain(4 * self.workers)

    def close(self) -> None:
        """Wait for every pending check."""
        self._drain(0)
        if self.pool is not None:
            self.pool.shutdown()
            self.pool = None

    def run_one(self, data: bytes) -> bool:
        """All checks on ``data``; True if it showed a new structure."""
        from ..parallel.corpus import compress_corpus

        new_structure = False
        compare = self.compare_left > 0 and len(data) <= COMPARE_MAX_LEN
        for pname, opts in self.presets.items():
            try:
                stream, meta = encode_with_structure(data, opts, device=self.device)
                why = None if zlib.decompress(stream, -15) == data else (
                    "zlib does not give the input back")
                if why is None and compare and (stream, meta) != encode_with_structure(
                        data, opts, device="cpu"):
                    why = "CUDA bytes differ from the CPU port's"
            except Exception as e:  # noqa: BLE001 - any fault is a finding
                why = f"{type(e).__name__}: {e}"
            if why is not None:
                self._fail(pname, data, why)
                continue
            self._check_inflate(pname, data, stream)
            key = structure_key(meta, pname)
            if key not in self.seen:
                self.seen.add(key)
                new_structure = True
        self.compared += compare
        self.compare_left -= compare
        # Every 8th multi-chunk input also round-trips through the batched
        # corpus engine (device-side compaction, compacted fetch, stored
        # host re-emission) with a varying batch size.
        self.inputs += 1
        if self.inputs % 8 == 0 and len(data) > 65536:
            bs = [2, 3, 5][self.inputs // 8 % 3]
            try:
                res = compress_corpus(data, next(iter(self.presets.values())), batch_size=bs,
                                      device=self.device)
                why = (None if zlib.decompress(res.deflate, wbits=-15) == data
                       else f"compress_corpus at batch_size={bs} does not round-trip")
            except Exception as e:  # noqa: BLE001
                why = f"compress_corpus at batch_size={bs}: {type(e).__name__}: {e}"
            self.corpus_checks += 1
            if why is not None:
                self._fail("corpus", data, why)
        return new_structure


def fuzz(iters: int = 200, *, seed: int = 0, max_len: int = 300_000,
         presets: str = "default,fast", device="cuda", compare_cpu: int = 0,
         out: str = OUT, log=print) -> dict:
    """Seed the corpus, then ``iters`` mutants (0: until interrupted)."""
    from ..compression_options import CompressionOptions

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fuzz: no CUDA device (pass device='cpu' for the CPU)")
    fz = Fuzzer({name: getattr(CompressionOptions, name)() for name in presets.split(",")},
                device=device, compare_cpu=compare_cpu, out=out)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    corpus = seeds(rng)
    n_seeds = len(corpus)
    try:
        for s in corpus:
            fz.run_one(s)
        base = len(fz.seen)
        log(f"seeded: {len(corpus)} inputs, {base} structures")
        i = 0
        while iters == 0 or i < iters:
            i += 1
            m = mutate(rng, corpus, max_len)
            if fz.run_one(m):
                corpus.append(m)
            if i % 50 == 0:
                log(f"iter {i}: corpus={len(corpus)} structures={len(fz.seen)} "
                    f"failures={len(fz.failures)}")
    finally:
        fz.close()
    return {"presets": presets, "seed": seed, "device": str(torch.device(device)), "iters": i,
            "seeds": n_seeds, "corpus": len(corpus), "structures_seeded": base,
            "structures": len(fz.seen), "compared_with_cpu": fz.compared,
            "corpus_checks": fz.corpus_checks, "failures": fz.failures,
            "seconds": time.perf_counter() - t0}


def replay(paths: list, presets: str, device="cuda", out: str = OUT) -> list:
    """The checks of a run on the inputs in ``paths``; returns the failures."""
    from ..compression_options import CompressionOptions

    fz = Fuzzer({name: getattr(CompressionOptions, name)() for name in presets.split(",")},
                device=device, compare_cpu=len(paths), out=out)
    try:
        for p in paths:
            with open(p, "rb") as f:
                fz.run_one(f.read())
    finally:
        fz.close()
    return fz.failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=200, help="0 = unbounded")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-len", type=int, default=300_000)
    ap.add_argument("--presets", default="default,fast",
                    help="comma list of CompressionOptions preset names (default,fast as the "
                         "reference's AFL target; high,rle,huffman_only for the exact-scoring "
                         "and run paths)")
    ap.add_argument("--compare-cpu", type=int, default=0, metavar="N",
                    help="hold the CUDA bytes equal to the CPU port's on the first N inputs "
                         f"of at most {COMPARE_MAX_LEN} B")
    ap.add_argument("--out", default=OUT, help="directory for failing inputs")
    ap.add_argument("--replay", nargs="+", metavar="FILE", help="check these inputs only")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("fuzz: no CUDA device (pass --device cpu for the CPU)", file=sys.stderr)
        return 1
    if a.replay:
        failures = replay(a.replay, a.presets, a.device, a.out)
        print(f"replayed {len(a.replay)} inputs: failures={len(failures)}")
        return 1 if failures else 0
    s = fuzz(a.iters, seed=a.seed, max_len=a.max_len, presets=a.presets, device=a.device,
             compare_cpu=a.compare_cpu, out=a.out, log=lambda m: print(m, flush=True))
    print(f"done: {s['iters']} iters, corpus grew {s['corpus']}, structures "
          f"{s['structures_seeded']}->{s['structures']}, failures={len(s['failures'])}")
    print(json.dumps(s))
    return 1 if s["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
