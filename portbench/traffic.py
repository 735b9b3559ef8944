"""The one traffic generator: it reads a mix's data file and makes its jobs.

A mix (``traffic/<name>.json``) is a closed loop of equal jobs.  Its
``recipe`` is ``utils/mix.py``'s ``build_mix`` (the recipe of ``bench.py``),
copied here so that ``--seed`` drives it: pg11 text, structured records,
random bytes and runs, in the recipe's proportions.  The seed seeds the
generator of the records and random bytes, rotates the text's start, and
draws each job's start in the pool, so every job of a run holds different
bytes of the same kinds.  The program receives only the bytes.
"""

from __future__ import annotations

import os

import numpy as np

from .spec import ROOT


def _rng(seed: int, stream: int) -> np.random.Generator:
    """A generator of ``seed`` (any size of whole number) for one use."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def unit(recipe: dict, seed: int) -> bytes:
    """One period of the mix of ``seed``: text, records, random bytes, runs."""
    with open(os.path.join(ROOT, recipe["text"]), "rb") as f:
        text = f.read()
    rot = int(_rng(seed, 0).integers(0, len(text)))
    return period(recipe, text[rot:] + text[:rot], _rng(seed, 1))


def period(recipe: dict, text: bytes, rng: np.random.Generator) -> bytes:
    """``build_mix``'s period from ``text`` and ``rng``."""
    rec = recipe["records"]
    tmpl = rng.integers(0, 256, rec["template_bytes"], dtype=np.uint8).tobytes()
    keep = rec["template_kept"]
    structured = b"".join(
        tmpl[:keep] + int(i).to_bytes(rec["counter_bytes"], "little")
        + rng.integers(0, 256, rec["random_tail_bytes"], dtype=np.uint8).tobytes()
        for i in range(rec["count"]))
    rand = rng.integers(0, 256, recipe["random_bytes"], dtype=np.uint8).tobytes()
    runs = b"".join(bytes.fromhex(p["hex"]) * p["repeat"] for p in recipe["runs"]["pieces"])
    return (text * recipe["text_copies"] + structured * rec["copies"] + rand
            + runs * recipe["runs"]["copies"])


class Jobs:
    """The jobs of one run of a mix: ``job_bytes`` each, cut from a pool of
    the mix at starts drawn from the seed.  ``grain`` aligns the starts (the
    ranks form cuts its rows on the chunk grid)."""

    def __init__(self, traffic: dict, seed: int, grain: int = 1):
        self.job_bytes = int(traffic["job_bytes"])
        period = unit(traffic["recipe"], seed)
        self.span = -(-len(period) // grain) * grain  # starts lie in [0, span]
        total = self.job_bytes + self.span
        self.pool = (period * (total // len(period) + 1))[:total]
        self.grain = grain
        self._starts = _rng(seed, 2)

    def next_start(self) -> int:
        """The start of the next job in the pool."""
        return int(self._starts.integers(0, self.span // self.grain + 1)) * self.grain

    def data(self, start: int) -> bytes:
        return self.pool[start : start + self.job_bytes]


class Sample:
    """A uniform sample of at most ``k`` of a run's jobs, drawn from the seed
    as they complete (reservoir sampling): what the check compares."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.seen = 0
        self.kept: list = []  # (job index, start, output)
        self._rng = _rng(seed, 3)

    def offer(self, start: int, output: bytes) -> None:
        j = self.seen
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((j, start, output))
            return
        r = int(self._rng.integers(0, j + 1))
        if r < self.k:
            self.kept[r] = (j, start, output)
